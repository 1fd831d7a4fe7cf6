"""The port's 3D training CLI against the JAX package's, on the CPU.

One synthetic PeRFception-ScanNet tree (written by the port's own writer)
and one start checkpoint feed both CLIs with the two flagship configs at a
small width (planes of 8, one block per stage) for 3 steps, validating at
step 2 and testing the best checkpoint at the end; then both resume to
step 5. Host and device augmentations are off (the device ones match only
in distribution). Every logged ``train/loss`` must agree within rtol
1e-4, ``val/mIoU`` within 1e-3, and ``last.ckpt``'s weights within 1e-5,
after the first run and after the resume. The other tests hold the CLI's
guards: a non-finite loss, more than one GPU; every conv method runs;
and a configuration the reference would calibrate, which the CLI now
calibrates too.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.train import checkpoints as jck  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.co3d_3d import train as tcli  # noqa: E402
from nerf_downstream_tpu_torch.data.synthetic import (  # noqa: E402
    write_scannet_tree,
)
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402

CFG = "co3d_3d/configs"
RUN = "b2x1-Res16UNet"


@pytest.fixture(autouse=True)
def _clean():
    jcfg.clear_config()
    tcfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jcfg.clear_config()
    tcfg.clear_config()


def flagship(root: str, extra=()) -> list:
    args = [
        "--ginc", f"{CFG}/scannet_plenoxel.gin",
        "--ginc", f"{CFG}/scannet_feature_sh.gin",
        "--ginb", f'PlenoxelScannetDataset.data_root = "{root}"',
        "--ginb", "PlenoxelScannetDataset.downsample_stride = 1",
        "--ginb", "PlenoxelScannetDataset.train_transformations = []",
        "--ginb", "train.device_transforms = []",
        "--ginb", "Res16UNet.PLANES = (8, 8, 8, 8, 8, 8, 8, 8)",
        "--ginb", "Res16UNet.LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)",
        "--ginb", "train.batch_size = 2",
        "--ginb", "train.val_batch_size = 1",
        "--ginb", "train.train_num_workers = 1",
        "--ginb", "train.val_num_workers = 1",
        "--ginb", "train.log_every_n_steps = 1",
        "--ginb", "train.val_every_n_steps = 2",
        "--ginb", "train.evaluate = True",
        "--ginb", 'train.loggers = ["csv", "jsonl"]',
    ]
    for b in extra:
        args += ["--ginb", b]
    return args


def read_jsonl(save: str) -> list:
    with open(os.path.join(save, RUN, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def losses(rows) -> dict:
    return {r["step"]: r["train/loss"] for r in rows if "train/loss" in r}


def mious(rows) -> list:
    return [r["val/mIoU"] for r in rows if "val/mIoU" in r]


def flat(tree, prefix=(), leaf=np.asarray):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,), leaf)
        else:
            yield prefix + (k,), leaf(v)


def test_cli_matches_reference_and_resumes(tmp_path):
    from co3d_3d import train as jcli

    root = write_scannet_tree(str(tmp_path), np.random.default_rng(0),
                              n_train=4, n_val=2)
    model = get_model("Res16UNet", in_channel=27, out_channel=20,
                      planes=(8,) * 8, layers=(1,) * 8)
    start = str(tmp_path / "start.ckpt")
    tree = convert.init_flax_variables(model, 5)
    tck.save_checkpoint(start, tree["params"], tree["batch_stats"])
    common = flagship(root, [f'train.checkpoint_path = "{start}"',
                             "train.load_weights = True"])
    saves = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}

    def run(max_steps, resume):
        extra = ["--ginb", f"train.max_steps = {max_steps}", "--seed", "3"]
        extra += ["--resume"] if resume else []
        jcfg.clear_config()
        jcli.main(common + extra + ["--save_path", saves["jax"]])
        tcfg.clear_config()
        tcli.main(common + extra + ["--save_path", saves["port"],
                                    "--device", "cpu"])

    for max_steps, resume in ((3, False), (5, True)):
        run(max_steps, resume)
        rows = {k: read_jsonl(v) for k, v in saves.items()}
        lj, lt = losses(rows["jax"]), losses(rows["port"])
        assert sorted(lt) == sorted(lj) and lj
        for step in lj:
            assert np.isfinite(lt[step])
            np.testing.assert_allclose(lt[step], lj[step], rtol=1e-4)
        mj, mt = mious(rows["jax"]), mious(rows["port"])
        assert len(mt) == len(mj) >= 2
        np.testing.assert_allclose(mt, mj, atol=1e-3)
        cj = jck.load_checkpoint(os.path.join(saves["jax"], "last.ckpt"))
        ct = tck.load_checkpoint(os.path.join(saves["port"], "last.ckpt"))
        assert ct["global_step"] == cj["global_step"] == max_steps
        pj = dict(flat(cj["params"]))
        pt = dict(flat(ct["params"]))
        assert pj.keys() == pt.keys()
        for k in pj:
            np.testing.assert_allclose(pt[k], pj[k], atol=1e-5, rtol=1e-5,
                                       err_msg=str(k))
    # the resumed run went on from step 3 (the log appends)
    assert sorted(losses(read_jsonl(saves["port"]))) == [1, 2, 3, 4]
    for name in ("best.ckpt", "eval_results.json"):
        assert os.path.exists(os.path.join(saves["port"], name))
    res = json.load(open(os.path.join(saves["port"], "eval_results.json")))
    assert np.isfinite(res["val/mIoU"])


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    return write_scannet_tree(str(tmp_path_factory.mktemp("tree")),
                              np.random.default_rng(1), n_train=2, n_val=1,
                              n_voxels=200)


def port_cli(root, save, extra=(), argv=()):
    tcfg.clear_config()
    return tcli.main(flagship(root, ["train.max_steps = 1",
                                     "train.evaluate = False", *extra])
                     + ["--save_path", str(save), "--device", "cpu",
                        *argv])


def test_cli_raises_on_nonfinite_loss(tiny_tree, tmp_path):
    # level caps far below the rows poison every level: the loss is NaN
    with pytest.raises(ValueError, match="Invalid train loss"):
        port_cli(tiny_tree, tmp_path,
                 ["CoordinateContext.level_caps = (256, 256, 256, 256, 256)"])
    assert not os.path.exists(tmp_path / "last.ckpt")


def test_cli_raises_on_more_than_one_gpu(tiny_tree, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        port_cli(tiny_tree, tmp_path, argv=["--gpus", "2"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        port_cli(tiny_tree, tmp_path, argv=["--dist_num_processes", "2"])


@pytest.mark.parametrize("binding", [
    'CoordinateContext.method = "block_resident"',
    'CoordinateContext.method = "row"',
    "CoordinateContext.grid_extent = None",
])
def test_cli_raises_on_unported_conv_method(tiny_tree, tmp_path, binding):
    """Every conv method runs now, and the run completes on it: the row
    path ("row", or "auto" without a grid extent) and "block_resident"
    (the tiny shells fill about 1.5 rows per block, so the block caps
    take divisor 1, as for the reference's CLI)."""
    extra = [binding]
    if "block_resident" in binding:
        extra.append("CoordinateContext.block_cap_divisor = 1")
    port_cli(tiny_tree, tmp_path, extra)
    assert os.path.exists(tmp_path / "last.ckpt")


def test_cli_raises_where_the_reference_calibrates(tiny_tree, tmp_path):
    # where the reference calibrates, the CLI now calibrates too (it used
    # to raise): the knobs are bound and the run completes
    port_cli(tiny_tree, tmp_path,
             ["CoordinateContext.window_escape_cap = None"])
    assert tcfg.query_parameter("CoordinateContext.level_caps") is not None
    assert tcfg.query_parameter("CoordinateContext.window_escape_cap") \
        is not None
    assert os.path.exists(tmp_path / "last.ckpt")


def test_cli_defaults_to_the_card(tiny_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    tcfg.clear_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(flagship(tiny_tree, ["train.max_steps = 1"])
                  + ["--save_path", str(tmp_path)])


def test_fresh_init_has_the_reference_spread():
    """A fresh init's per-layer standard deviations within 5 % of the
    reference's, at the flagship's full width: each kernel against a draw
    of the reference's initializer (He-normal over K * Cin) at its shape,
    the BatchNorm leaves and biases equal to the reference's constant
    initializers (scale and variance 1, bias and mean 0). The reference's
    tree comes from ``jax.eval_shape`` of its init (shapes only)."""
    import jax
    import jax.numpy as jnp

    from nerf_downstream_tpu.models import get_model as jget_model
    from nerf_downstream_tpu.models.mink.layers import _kaiming_conv_init
    from nerf_downstream_tpu.sparse.types import PointField
    from nerf_downstream_tpu_torch.train.modules import init_variables

    model = init_variables(get_model("Res16UNet", in_channel=27,
                                     out_channel=20), 0)
    field = PointField(coords=jnp.zeros((64, 4), jnp.float32),
                       feats=jnp.zeros((64, 27), jnp.float32),
                       mask=jnp.zeros(64, bool))
    jcfg.parse_config('CoordinateContext.method = "hybrid"\n'
                      "CoordinateContext.window_tile = 64\n")
    jm = jget_model("Res16UNet", in_channel=27, out_channel=20)
    ref = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), field))
    rflat = dict(flat({"params": ref["params"],
                       "batch_stats": ref["batch_stats"]},
                      leaf=lambda x: x))
    oflat = dict(flat(convert.state_dict_to_flax(model.state_dict())))
    assert rflat.keys() == oflat.keys()
    const = {"scale": 1.0, "var": 1.0, "bias": 0.0, "mean": 0.0}
    for i, (k, r) in enumerate(sorted(rflat.items())):
        o = oflat[k]
        assert o.shape == tuple(r.shape), k
        if k[-1] == "kernel":
            draw = np.asarray(_kaiming_conv_init(jax.random.PRNGKey(i),
                                                 tuple(r.shape)))
            np.testing.assert_allclose(o.std(), draw.std(), rtol=0.05,
                                       err_msg=str(k))
        else:
            np.testing.assert_array_equal(o, np.full(o.shape, const[k[-1]],
                                                     np.float32),
                                          err_msg=str(k))
