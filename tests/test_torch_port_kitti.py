"""SemanticKITTI, Stanford, the last six host transforms and the import
of the reference's PyTorch checkpoints, in the port against the JAX
package, on the CPU.

- ``RegionDropout``, ``DimensionlessCoordinates``, ``PerlinNoise``,
  ``FarthestPointSample``, ``RandomSample`` and ``LabelBasedSample``
  against the reference at one seed: integer outputs equal, floats within
  1e-6.
- The KITTI label maps equal; ``SemanticKITTIDataset`` items (train with
  its default transforms, and val) equal on a tree the test writes
  (``data.synthetic.write_kitti_tree`` at 8 beams x 256 azimuths), and
  the ``save_prediction`` files byte for byte.
- ``StanfordDataset`` items equal on ScanNet-layout rooms with Stanford's
  split files.
- ``train/torch_import.py`` on Lightning checkpoints the test writes
  (Res16UNet14 and ResNet14, ME's key names, kernel-volume-1 convs as 2D,
  BN counters and extra entries of plain types): the reference's import
  followed by ``convert``'s flax -> port mapping equals the port's import
  bit for bit, and Res16UNet14's logits with the imported weights are
  within 1e-5 x max of the reference's.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_port_rowpath as R  # noqa: E402
from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.data import semantic_kitti as jkitti  # noqa: E402
from nerf_downstream_tpu.data import stanford as jstan  # noqa: E402
from nerf_downstream_tpu.data import transforms as JT  # noqa: E402
from nerf_downstream_tpu.models import get_model as jget_model  # noqa: E402
from nerf_downstream_tpu.train import torch_import as jimp  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.data import semantic_kitti as tkitti  # noqa: E402
from nerf_downstream_tpu_torch.data import stanford as tstan  # noqa: E402
from nerf_downstream_tpu_torch.data import transforms as TT  # noqa: E402
from nerf_downstream_tpu_torch.data.datasets import get_dataset  # noqa: E402
from nerf_downstream_tpu_torch.data.synthetic import (  # noqa: E402
    write_kitti_tree,
    write_scannet_ply_tree,
)
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.train import torch_import as timp  # noqa: E402

KITTI_SCAN = dict(beams=8, azimuths=256)


@pytest.fixture(autouse=True)
def _clean():
    jcfg.clear_config()
    tcfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jcfg.clear_config()
    tcfg.clear_config()


# -- transforms ---------------------------------------------------------------

TRANSFORM_CASES = {
    "RegionDropout": dict(box_center_range=(2, 2, 1),
                          max_region_size=(6, 6, 6),
                          min_region_size=(2, 2, 2), application_ratio=1.0),
    "DimensionlessCoordinates": dict(voxel_size=0.05),
    "PerlinNoise": dict(noise_params=((4, 4), (16, 16)),
                        application_ratio=1.0),
    "FarthestPointSample": dict(num_points=64),
    "RandomSample": dict(num_points=300),
    "LabelBasedSample": dict(filter_label=2),
}


@pytest.mark.parametrize("name", sorted(TRANSFORM_CASES))
def test_six_transforms_match_reference(rng, name):
    coords = (rng.random((400, 3)) * 20).astype(np.float32)
    feats = rng.normal(size=(400, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 400)
    outs = []
    for mod in (TT, JT):
        mod.seed(13)
        t = mod.TRANSFORMS[name](**TRANSFORM_CASES[name])
        outs.append([t(coords.copy(), feats.copy(), labels.copy())
                     for _ in range(3)])
    for (tc, tf, tl), (jc, jf, jl) in zip(*outs):
        np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tl, jl)
    assert TT.build([name]) is not None


# -- SemanticKITTI and Stanford -----------------------------------------------

@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    return write_kitti_tree(str(tmp_path_factory.mktemp("kitti")),
                            np.random.default_rng(0), **KITTI_SCAN)


def test_kitti_label_maps_match_reference():
    for ignore in (-100, -255):
        for a, b in zip(tkitti.build_kitti_label_maps(ignore),
                        jkitti.build_kitti_label_maps(ignore)):
            np.testing.assert_array_equal(a, b)


def test_kitti_dataset_and_predictions_match_reference(kitti_tree, tmp_path):
    assert get_dataset("SemanticKITTIDataset") is tkitti.SemanticKITTIDataset
    for phase in ("train", "val"):
        TT.seed(4)
        JT.seed(4)
        tds = tkitti.SemanticKITTIDataset(phase, data_root=kitti_tree)
        jds = jkitti.SemanticKITTIDataset(phase, data_root=kitti_tree)
        assert tds.pc_files == jds.pc_files
        assert len(tds) == (2 if phase == "train" else 1)
        for i in range(len(tds)):
            a, b = tds[i], jds[i]
            for k in ("coordinates", "features", "labels"):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["metadata"] == b["metadata"]
            assert a["features"].shape[1] == 4
            lab = a["labels"]
            assert (lab == -100).any() and (lab >= 0).any()
            assert lab.max() < 19
    item = tds[0]
    pred = np.random.default_rng(1).integers(0, 19, len(item["labels"]))
    files = [ds.save_prediction(pred, str(tmp_path / tag), item["metadata"])
             for ds, tag in ((tds, "port"), (jds, "jax"))]
    assert files[0].endswith(os.path.join("sequences", "08", "predictions",
                                          "000000.label"))
    with open(files[0], "rb") as f, open(files[1], "rb") as g:
        assert f.read() == g.read()


def test_stanford_dataset_matches_reference(tmp_path):
    root = write_scannet_ply_tree(str(tmp_path), np.random.default_rng(2),
                                  n_train=2, n_val=1, n_vertices=800,
                                  extent=(1.0, 1.5), height=1.0, boxes=2)
    for phase in ("train", "val"):
        with open(os.path.join(root, f"scannetv2_{phase}.txt")) as f, \
                open(os.path.join(root, f"stanford_{phase}.txt"), "w") as g:
            g.write(f.read())
    assert get_dataset("StanfordDataset") is tstan.StanfordDataset
    for phase in ("train", "val"):
        TT.seed(6)
        JT.seed(6)
        tds = tstan.StanfordDataset(phase, data_root=root)
        jds = jstan.StanfordDataset(phase, data_root=root)
        assert len(tds) == len(jds) == (2 if phase == "train" else 1)
        for i in range(len(tds)):
            for k in ("coordinates", "features", "labels"):
                np.testing.assert_array_equal(tds[i][k], jds[i][k],
                                              err_msg=k)


# -- reference checkpoint import ----------------------------------------------

_UNITS = {"conv0a": ("conv0p1s1", 0), "conv0b": ("conv0p1s1", 3),
          "conv1": ("conv1p1s2", 0), "conv2": ("conv2p2s2", 0),
          "conv3": ("conv3p4s2", 0), "conv4": ("conv4p8s2", 0),
          "convtr4": ("convtr4p16s2", 0), "convtr5": ("convtr5p8s2", 0),
          "convtr6": ("convtr6p4s2", 0), "convtr7": ("convtr7p2s2", 0)}


def me_key(key: str) -> str:
    """The reference's Lightning key of a port key (ME's names)."""
    p = key.split(".")
    if p[0] in _UNITS and len(p) == 3:
        seq, i = _UNITS[p[0]]
        if p[1] == "conv":
            return f"model.{seq}.{i}.{p[2]}"
        return f"model.{seq}.{i + 1}.bn.{p[2]}"
    if p[0] == "norm":  # the ResNet stem norm
        return f"model.bn1.bn.{p[1]}"
    if p[0].startswith("layer"):
        li, bj = p[0][len("layer"):].split("_block")
        p = [f"layer{li}", bj] + p[1:]
    if p[0].startswith(("block", "layer")) and len(p) > 3:
        rest = p[2:]
        if rest[0] == "downsample":
            rest = (["downsample", "0"] if rest[1] == "conv"
                    else ["downsample", "1", "bn"]) + rest[2:]
        elif rest[0].startswith("norm"):
            rest = [rest[0], "bn"] + rest[1:]
        return "model." + ".".join(p[:2] + rest)
    return "model." + key


def write_reference_checkpoint(model, path, seed):
    """A Lightning checkpoint of ``model``'s reference counterpart: random
    values, ME's key names and layouts, BN counters, and entries of plain
    types beside the state dict."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, v in model.state_dict().items():
        arr = rng.normal(size=tuple(v.shape)).astype(np.float32)
        if key.endswith("running_var"):
            arr = np.abs(arr) + 0.5
        if key.endswith("kernel") and arr.ndim == 3 and arr.shape[0] == 1:
            arr = arr[0]  # ME keeps a kernel-volume-1 conv 2D
        sd[me_key(key)] = torch.as_tensor(arr)
        if key.endswith("running_mean"):
            sd[me_key(key).replace("running_mean", "num_batches_tracked")] = \
                torch.tensor(7)
    torch.save({"epoch": 3, "global_step": 120, "state_dict": sd,
                "hyper_parameters": {"lr": 0.1, "name": "reference"}}, path)


@pytest.mark.parametrize("name", ["Res16UNet14", "ResNet14"])
def test_torch_import_matches_reference(name, tmp_path):
    kw = (dict(planes=(8,) * 8) if name.startswith("Res16")
          else dict(planes=(8,) * 4))
    model = get_model(name, in_channel=3, out_channel=5, num_batches=1,
                      **kw)
    start = convert.init_flax_variables(model, 2)
    convert.load_flax_variables(model, start)
    path = str(tmp_path / "reference.ckpt")
    write_reference_checkpoint(model, path, 3)
    timp.import_reference_checkpoint(path, name, model)
    jp, js = jimp.import_reference_checkpoint(path, name, start["params"],
                                              start["batch_stats"])
    want = convert.flax_to_state_dict(model, {"params": jp,
                                              "batch_stats": js})
    got = model.state_dict()
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(),
                                      err_msg=key)
    # every weight came from the checkpoint
    assert not np.array_equal(got["final.bias"].numpy(),
                              np.asarray(start["params"]["final"]["bias"]))
    if not name.startswith("Res16"):
        return
    batch = R.unet_batch()
    jmodel = jget_model(name=name, in_channel=3, out_channel=5,
                        num_batches=R.SCENES, **kw)
    model = get_model(name, in_channel=3, out_channel=5,
                      num_batches=R.SCENES, **kw)
    timp.import_reference_checkpoint(path, name, model)
    from nerf_downstream_tpu.sparse.types import PointField as JField
    from nerf_downstream_tpu_torch.sparse.types import PointField

    jf = JField(coords=jnp.asarray(batch["coordinates"]),
                feats=jnp.asarray(batch["features"]),
                mask=jnp.asarray(batch["mask"]))
    ref = np.asarray(jax.jit(lambda v, f: jmodel.apply(v, f, train=False))(
        jax.tree_util.tree_map(jnp.asarray, {"params": jp,
                                              "batch_stats": js}), jf))
    tf = PointField(coords=torch.as_tensor(batch["coordinates"]),
                    feats=torch.as_tensor(batch["features"]),
                    mask=torch.as_tensor(batch["mask"]))
    with torch.no_grad():
        got = model.eval()(tf).numpy()
    m = batch["mask"]
    R.close_to_largest(got[m], ref[m], 1e-5, "imported logits")


def test_torch_import_refuses_a_shape_that_differs(tmp_path):
    model = get_model("Res16UNet14", in_channel=3, out_channel=5,
                      planes=(8,) * 8)
    path = str(tmp_path / "reference.ckpt")
    write_reference_checkpoint(model, path, 4)
    other = get_model("Res16UNet14", in_channel=3, out_channel=7,
                      planes=(8,) * 8)
    with pytest.raises(ValueError, match="shape mismatch at final"):
        timp.import_reference_checkpoint(path, "Res16UNet14", other)
    with pytest.raises(ValueError, match="no import mapping"):
        timp.import_reference_checkpoint(path, "MinkowskiFCNN", model)
