"""The port's ScanNet-over-PLY slice against the JAX package's, on the CPU.

- The PLY reader (binary little-endian, as ``write_scannet_ply_tree``
  writes it, and ascii) and ``load_ply``: arrays equal to the reference's
  exactly.
- ``sparse_quantize`` (first point per cell, a cell's conflicting labels
  to ``ignore_label``): indices and labels equal exactly.
- The five colour transforms (``ChromaticTranslation``,
  ``ChromaticAutoContrast``, ``ChromaticJitter``, ``NormalizeColor``,
  ``HueSaturationTranslation``), each applied always, from generators
  seeded alike: outputs equal exactly.
- ``ScannetDataset`` under ``scannet_semseg.gin`` unchanged but the data
  root, train and val samples from transform streams seeded alike:
  coordinates, features and labels equal exactly.
- ``scannet_semseg.gin`` through both training CLIs at planes of 8, one
  block per stage, batch 2, one worker, the config's host augmentation
  list, 2 steps validating after the second, from one start
  checkpoint, uncalibrated (``train.auto_calibrate = False`` in both: the
  reference calibrates on the run's own streams, the port on copies of
  them, so calibrated runs would draw different batches; the batches are
  equal): every logged ``train/loss`` and ``val/loss`` within rtol 1e-3
  (measured: the train loss of the second step, a train-mode forward,
  1.9e-4 apart; the val loss, an eval-mode forward of the weights one
  step later, 3e-6 apart); ``val/mIoU`` within
  0.05 points (an argmax near a tie may flip on a few of the 1,000
  points of a near-random model).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.data import ply as jply  # noqa: E402
from nerf_downstream_tpu.data import scannet as jscan  # noqa: E402
from nerf_downstream_tpu.data import transforms as JT  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.data import ply as tply  # noqa: E402
from nerf_downstream_tpu_torch.data import scannet as tscan  # noqa: E402
from nerf_downstream_tpu_torch.data import transforms as TT  # noqa: E402
from nerf_downstream_tpu_torch.data.synthetic import (  # noqa: E402
    write_scannet_ply_tree,
)
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402

CFG = "co3d_3d/configs/scannet_semseg.gin"
ROOMS = dict(n_vertices=1000, extent=(1.0, 1.6), height=1.0, boxes=2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    jcfg.clear_config()
    tcfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jcfg.clear_config()
    tcfg.clear_config()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_scannet_ply_tree(str(tmp_path_factory.mktemp("scannet")),
                                  np.random.default_rng(0), n_train=2,
                                  n_val=1, **ROOMS)


def test_ply_reader_matches_reference(tree, tmp_path):
    path = os.path.join(tree, "train", "scene0000_00.ply")
    for a, b in zip(tply.load_ply(path, True, True),
                    jply.load_ply(path, True, True)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    v = tply.read_ply_vertices(path)
    assert v.dtype.names == ("x", "y", "z", "red", "green", "blue", "label",
                             "instance")
    # an ascii file with a face element after the vertices
    rows = [f"{x:.4f} {y:.4f} {z:.4f} {r} {g} {b} {lab}"
            for (x, y, z), (r, g, b), lab in zip(
                np.round(np.random.default_rng(1).random((5, 3)), 4),
                np.random.default_rng(2).integers(0, 256, (5, 3)),
                [1, 2, 0, 5, 39])]
    text = "\n".join(
        ["ply", "format ascii 1.0", "comment synthetic", "element vertex 5",
         "property float x", "property float y", "property float z",
         "property uchar red", "property uchar green", "property uchar blue",
         "property ushort label", "element face 0",
         "property list uchar int vertex_indices", "end_header", *rows])
    asc = tmp_path / "a.ply"
    asc.write_text(text + "\n")
    for a, b in zip(tply.load_ply(str(asc), True, True),
                    jply.load_ply(str(asc), True, True)):
        np.testing.assert_array_equal(a, b)
    assert tply.load_ply(str(asc), True)[2].tolist() == [1, 2, 0, 5, 39]


def test_sparse_quantize_matches_reference(rng):
    xyz = (rng.random((4000, 3)) * 0.5 - 0.1).astype(np.float32)
    labels = rng.integers(0, 4, 4000)
    for q in (0.01, 0.05):
        ti, tl = tscan.sparse_quantize(xyz, q, labels, -100)
        ji, jl = jscan.sparse_quantize(xyz, q, labels, -100)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        assert (tl == -100).any() and (tl >= 0).any()
    ti, tl = tscan.sparse_quantize(xyz, 0.05)
    np.testing.assert_array_equal(ti, jscan.sparse_quantize(xyz, 0.05)[0])
    assert tl is None


@pytest.mark.parametrize("name", [
    "ChromaticTranslation", "ChromaticAutoContrast", "ChromaticJitter",
    "NormalizeColor", "HueSaturationTranslation",
])
def test_colour_transforms_match_reference(rng, name):
    coords = rng.random((500, 3)).astype(np.float32) * 50
    feats = rng.integers(0, 256, (500, 3)).astype(np.float32)
    labels = rng.integers(0, 20, 500)
    kw = {} if name in ("NormalizeColor", "HueSaturationTranslation") \
        else {"application_ratio": 1.0}
    outs = []
    for mod in (TT, JT):
        mod.seed(11)
        t = mod.TRANSFORMS[name](**kw)
        outs.append([t(coords.copy(), feats.copy(), labels.copy())
                     for _ in range(3)])
    for (tc, tf, tl), (jc, jf, jl) in zip(*outs):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tl, jl)
    assert not np.array_equal(outs[0][0][1], feats)


def test_scannet_dataset_matches_reference(tree):
    bind = [f'ScannetDataset.data_root = "{tree}"']
    jcfg.parse_config_files_and_bindings([CFG], bind)
    tcfg.parse_config_files_and_bindings([CFG], bind)
    for phase in ("train", "val"):
        TT.seed(5)
        JT.seed(5)
        tds, jds = tscan.ScannetDataset(phase), jscan.ScannetDataset(phase)
        assert len(tds) == len(jds) == (2 if phase == "train" else 1)
        for i in range(len(tds)):
            a, b = tds[i], jds[i]
            for k in ("coordinates", "features", "labels"):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["features"].shape[1] == 3
            assert (a["labels"] >= 0).any() and (a["labels"] < 20).all()
    from nerf_downstream_tpu_torch.data.datasets import get_dataset

    assert get_dataset("ScannetDataset") is tscan.ScannetDataset


def test_semseg_config_trains_in_both_clis(tree, tmp_path):
    from co3d_3d import train as jcli
    from nerf_downstream_tpu_torch.co3d_3d import train as tcli

    model = get_model("Res16UNet", in_channel=3, out_channel=20,
                      planes=(8,) * 8, layers=(1,) * 8)
    start = str(tmp_path / "start.ckpt")
    variables = convert.init_flax_variables(model, 5)
    tck.save_checkpoint(start, variables["params"], variables["batch_stats"])
    args = ["--ginc", CFG]
    for b in (f'ScannetDataset.data_root = "{tree}"',
              "Res16UNet.PLANES = (8, 8, 8, 8, 8, 8, 8, 8)",
              "Res16UNet.LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)",
              "train.batch_size = 2", "train.val_batch_size = 1",
              "train.train_num_workers = 1", "train.val_num_workers = 1",
              "train.max_steps = 2", "train.val_every_n_steps = 1",
              "train.log_every_n_steps = 1", 'train.loggers = ["jsonl"]',
              "train.auto_calibrate = False",
              f'train.checkpoint_path = "{start}"',
              "train.load_weights = True"):
        args += ["--ginb", b]
    args += ["--seed", "3"]
    saves = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jcfg.clear_config()
    jcli.main(args + ["--save_path", saves["jax"]])
    tcfg.clear_config()
    tcli.main(args + ["--save_path", saves["port"], "--device", "cpu"])
    rows = {}
    for k, save in saves.items():
        with open(os.path.join(save, "b2x1-Res16UNet", "metrics.jsonl")) as f:
            rows[k] = [json.loads(line) for line in f]
    loss = {k: {r["step"]: r["train/loss"] for r in v if "train/loss" in r}
            for k, v in rows.items()}
    assert sorted(loss["port"]) == sorted(loss["jax"]) == [1]
    for step, want in loss["jax"].items():
        assert np.isfinite(loss["port"][step])
        np.testing.assert_allclose(loss["port"][step], want, rtol=1e-3)
    val = {k: [(r["val/loss"], r["val/mIoU"]) for r in v if "val/mIoU" in r]
           for k, v in rows.items()}
    assert len(val["port"]) == len(val["jax"]) == 1
    for (tl, tm), (jl, jm) in zip(val["port"], val["jax"]):
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        np.testing.assert_allclose(tm, jm, atol=0.05)
    assert os.path.exists(os.path.join(saves["port"], "best.ckpt"))
