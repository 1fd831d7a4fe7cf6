"""The port's evaluation CLI (``co3d_3d/eval.py``) against the JAX
package's, on the CPU, from one checkpoint each.

- Segmentation on the tree of ``tests/test_cli_3d.py::
  test_train_and_eval_cli_scannet_seg`` (the flagship configs at planes
  of 8, one block per stage) from a port-written checkpoint with random
  weights and BatchNorm statistics: every value of ``{tag}.json`` but the
  wall time within 1e-5 relative, the ``--visualize`` files (same names,
  the same coordinates and labels, logits within 1e-5 x their largest),
  the skip of an existing tag, ``--replace``, and ``--profile`` writing a
  trace.
- Classification (``co3d_cls.gin`` with ResNet14 at planes of 8, train
  and val batch sizes equal, ROADMAP Queue 3) with ``--training_module
  ClassificationTraining``: ``val/acc1``, ``val/acc5`` and ``val/loss``
  within 1e-5 relative.
- ``--sparsify --layout csr`` on a checkpoint with half its 4 x 4 weight
  blocks zeroed (as ``test_eval_cli_sparsify_blocksparse`` builds it) at
  ``block_live_granularity = 4``, mode 1 in slot 0 (``conv0a``-``conv4``)
  and dense elsewhere: the bound ``block_live_map`` and
  ``valid_offsets_map`` equal, and the results within 1e-5 relative.
- ``--convert_powernorm`` with ``Res16UNet.NORM_TYPE = "PN"`` on a
  BatchNorm checkpoint: the reference's CLI raises at the load there (its
  converter runs after ``restore_into``, which refuses the BatchNorm
  names; ROADMAP Queue 3), so the port's result is held to the
  reference's CLI on the checkpoint that the JAX package's
  ``convert_powernorm_state`` makes.
- The CLI raises without a GPU unless ``--device cpu`` is given.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.co3d_3d import eval as tcli  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from tests.test_cli_3d import write_co3d_tree, write_scannet_tree  # noqa: E402

CFG = "co3d_3d/configs"
SEG = [
    "--ginc", f"{CFG}/scannet_plenoxel.gin",
    "--ginc", f"{CFG}/scannet_feature_sh.gin",
    "--ginb", "PlenoxelScannetDataset.downsample_stride = 1",
    "--ginb", "PlenoxelScannetDataset.train_transformations = []",
    "--ginb", "Res16UNet.PLANES = (8, 8, 8, 8, 8, 8, 8, 8)",
    "--ginb", "Res16UNet.LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)",
    "--ginb", "CoordinateContext.block_cap_divisor = 1",
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # the reference's XLA fallback of its window convs (its Pallas
    # kernels' interpreted forms are held to the port elsewhere)
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    jcfg.clear_config()
    tcfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jcfg.clear_config()
    tcfg.clear_config()


def run_jax(args):
    from co3d_3d import eval as jcli

    jcfg.clear_config()
    return jcli.main(args)


def run_port(args):
    tcfg.clear_config()
    return tcli.main(args + ["--device", "cpu"])


def same_results(got: dict, want: dict):
    keys = set(want) - {"val/iter_time"}
    assert keys <= set(got), (sorted(got), sorted(want))
    for k in sorted(keys):
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def read(save, tag) -> dict:
    with open(os.path.join(save, f"{tag}.json")) as f:
        out = json.load(f)
    assert isinstance(out, list) and len(out) == 1
    return out[0]


def seg_checkpoint(tmp_path, rng, transform=None) -> str:
    model = get_model("Res16UNet", in_channel=27, out_channel=20,
                      planes=(8,) * 8, layers=(1,) * 8)
    tree = convert.init_flax_variables(model, 5)
    if transform is not None:
        tree = transform(tree)
    path = str(tmp_path / "run" / "start.ckpt")
    tck.save_checkpoint(path, tree["params"], tree["batch_stats"])
    return path


def test_segmentation_eval_matches_reference(tmp_path, rng, capsys):
    root = write_scannet_tree(tmp_path, rng)
    ckpt = seg_checkpoint(tmp_path, rng)
    args = SEG + ["--ginb", f'PlenoxelScannetDataset.data_root = "{root}"',
                  "--load_path", ckpt, "--tag", "seg", "--visualize"]
    saves = {k: str(tmp_path / k) for k in ("jax", "port")}
    want = run_jax(args + ["--save_path", saves["jax"]])
    got = run_port(args + ["--save_path", saves["port"]])
    assert "num_params, total=" in capsys.readouterr().out
    assert read(saves["port"], "seg") == got
    same_results(got, want)
    same_results(read(saves["port"], "seg"), read(saves["jax"], "seg"))
    figs = {k: os.path.join(v, "figure", "seg") for k, v in saves.items()}
    names = sorted(os.listdir(figs["jax"]))
    assert names and sorted(os.listdir(figs["port"])) == names
    for name in names:
        a = np.load(os.path.join(figs["port"], name))
        b = np.load(os.path.join(figs["jax"], name))
        assert sorted(a.files) == sorted(b.files)
        for k in ("coordinates", "labels", "dists"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        scale = float(np.abs(b["logits"]).max())
        np.testing.assert_allclose(a["logits"], b["logits"], rtol=0,
                                   atol=1e-5 * scale)
    # an existing tag is skipped, --replace runs again
    mtime = os.path.getmtime(os.path.join(saves["port"], "seg.json"))
    assert run_port(args + ["--save_path", saves["port"]]) is None
    assert "skip existing experiment" in capsys.readouterr().out
    assert os.path.getmtime(os.path.join(saves["port"], "seg.json")) == mtime
    again = run_port(args + ["--save_path", saves["port"], "--replace",
                             "--profile"])
    same_results(again, got)
    assert os.path.getsize(os.path.join(saves["port"], "trace",
                                        "trace.json")) > 0
    # the default tag: <run dir>-<device>-<sparsify>, next to the ckpt
    run_port(SEG + ["--ginb", f'PlenoxelScannetDataset.data_root = "{root}"',
                    "--load_path", ckpt])
    assert os.path.exists(tmp_path / "run" / "run-cpu-False.json")


def test_classification_eval_matches_reference(tmp_path, rng):
    root, fdir = write_co3d_tree(tmp_path, rng)
    model = get_model("ResNet14", in_channel=27, out_channel=51,
                      planes=(8, 8, 8, 8), init_dim=8)
    tree = convert.init_flax_variables(model, 2)
    ckpt = str(tmp_path / "run" / "start.ckpt")
    tck.save_checkpoint(ckpt, tree["params"], tree["batch_stats"])
    args = []
    for name in ("co3d_cls.gin", "co3d_aug2.gin", "feature_sh.gin",
                 "resnet14.gin"):
        args += ["--ginc", f"{CFG}/{name}"]
    for b in (f'Co3DDatasetBase.data_root = "{root}"',
              f'Co3DDatasetBase.filelist_dir = "{fdir}"',
              "Co3DDatasetBase.downsample_stride = 1",
              "get_model.planes = (8, 8, 8, 8)", "get_model.init_dim = 8",
              "train.batch_size = 2", "evaluate.val_batch_size = 2"):
        args += ["--ginb", b]
    args += ["--load_path", ckpt, "--tag", "cls",
             "--training_module", "ClassificationTraining"]
    want = run_jax(args + ["--save_path", str(tmp_path / "jax")])
    got = run_port(args + ["--save_path", str(tmp_path / "port")])
    assert {"val/acc1", "val/acc5", "val/loss"} <= set(want)
    same_results(got, want)


def block_pruned(tree, blk: int = 4, seed: int = 3):
    """Half the blk x blk blocks of every k3 conv kernel zeroed (the
    structure the block tier skips)."""
    prng = np.random.default_rng(seed)

    def prune(node, path=()):
        if isinstance(node, dict):
            return {k: prune(v, path + (k,)) for k, v in node.items()}
        arr = np.asarray(node)
        if path[-1] == "kernel" and arr.ndim == 3 and arr.shape[0] == 27:
            arr = arr.copy()
            for k in range(27):
                for bi in range(arr.shape[1] // blk):
                    for bo in range(arr.shape[2] // blk):
                        if prng.random() < 0.5:
                            arr[k, bi * blk:(bi + 1) * blk,
                                bo * blk:(bo + 1) * blk] = 0
        return arr

    return dict(tree, params=prune(tree["params"]))


def test_sparsify_csr_eval_matches_reference(tmp_path, rng):
    root = write_scannet_tree(tmp_path, rng)
    ckpt = seg_checkpoint(tmp_path, rng, block_pruned)
    args = SEG + ["--ginb", f'PlenoxelScannetDataset.data_root = "{root}"',
                  "--ginb", "CoordinateContext.block_live_granularity = 4",
                  "--load_path", ckpt, "--tag", "bs", "--sparsify",
                  "--sparse_mode", "1,3,3,3,3,3,3,3,3", "--layout", "csr"]
    want = run_jax(args + ["--save_path", str(tmp_path / "jax")])
    jmap = jcfg.query_parameter("CoordinateContext.block_live_map")
    jvmap = jcfg.query_parameter("CoordinateContext.valid_offsets_map",
                                 default=None)
    got = run_port(args + ["--save_path", str(tmp_path / "port")])
    tmap = tcfg.query_parameter("CoordinateContext.block_live_map")
    tvmap = tcfg.query_parameter("CoordinateContext.valid_offsets_map",
                                 default=None)
    assert jmap and sorted(tmap) == sorted(jmap)
    for k in jmap:
        np.testing.assert_array_equal(tmap[k], np.asarray(jmap[k]),
                                      err_msg=k)
    assert (tvmap or {}) == {k: tuple(v) for k, v in (jvmap or {}).items()}
    same_results(got, want)


def test_convert_powernorm_eval(tmp_path, rng):
    from nerf_downstream_tpu.models.mink.powernorm import (
        convert_powernorm_state,
    )

    root = write_scannet_tree(tmp_path, rng)
    ckpt = seg_checkpoint(tmp_path, rng)
    args = SEG + ["--ginb", f'PlenoxelScannetDataset.data_root = "{root}"',
                  "--ginb", 'Res16UNet.NORM_TYPE = "PN"', "--tag", "pn"]
    def to_pn(params, stats):  # the JAX package's own state transform
        p_out, s_out = {}, {}
        for k in set(params) | set(stats):
            if k.startswith("MaskedBatchNorm_"):
                name = "MinkPowerNorm_" + k.split("_")[-1]
                p_out[name], s = convert_powernorm_state(params[k], stats[k])
                s_out[name] = {n: np.asarray(v, np.int32 if n == "iters"
                                             else np.float32)
                               for n, v in s.items()}
            elif isinstance(params.get(k, stats.get(k)), dict):
                p_out[k], s_out[k] = to_pn(params.get(k, {}),
                                           stats.get(k, {}))
                if not s_out[k]:
                    del s_out[k]
            else:
                p_out[k] = params[k]
        return p_out, s_out

    raw = tck.load_checkpoint(ckpt)
    pn_ckpt = str(tmp_path / "pnrun" / "pn.ckpt")
    tck.save_checkpoint(pn_ckpt, *to_pn(raw["params"], raw["batch_stats"]))
    want = run_jax(args + ["--load_path", pn_ckpt,
                           "--save_path", str(tmp_path / "jax")])
    got = run_port(args + ["--load_path", ckpt, "--convert_powernorm",
                           "--save_path", str(tmp_path / "port")])
    same_results(got, want)


def test_eval_cli_needs_a_gpu_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="cpu"):
        tcli.main(SEG + ["--load_path", str(tmp_path / "x.ckpt")])
