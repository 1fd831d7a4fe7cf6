"""``co3d_3d/train.py`` on SemanticKITTI, on the CPU: the flagship config
(``scannet_plenoxel.gin``) with the KITTI reader (``xyzi`` features, 19
classes), ``CoordinateContext.method = "hybrid"`` without a grid extent
(the fully-windowed path on packed keys alone) and no level caps (LiDAR
levels do not thin as the config's ``level_cap_decay = 0.5`` assumes:
at 0.05 m a scan's rows drop by about 2 % from stride 1 to 2, so the
caps NaN-poison, in both packages and on every route), Res16UNet at
planes 8, on scans the test writes (``data.synthetic.write_kitti_tree``
at 16 beams x 256 azimuths).

- The port's CLI alone (8 beams): 2 steps and validations, finite
  losses and a validation mIoU.
- Both packages' CLIs from one start checkpoint (``-m slow``: the
  reference's CLI compiles for about a minute): train and validation
  losses within rtol 1e-4.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.data.synthetic import (  # noqa: E402
    write_kitti_tree,
)
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402

CFG = "co3d_3d/configs/scannet_plenoxel.gin"


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


def kitti_bindings(root: str) -> list:
    """The flagship config turned to SemanticKITTI, as the CLI takes it."""
    return [
        'get_dataset.dataset_name = "SemanticKITTIDataset"',
        f'SemanticKITTIDataset.data_root = "{root}"',
        "SemanticKITTIDataset.ignore_label = -255",
        "get_model.in_channel = 4", "get_model.out_channel = 19",
        'CoordinateContext.method = "hybrid"',
        "CoordinateContext.grid_extent = None",
        "CoordinateContext.level_cap_decay = None",
        "train.device_transforms = []",
    ]


def cli_args(root: str, start: str | None = None) -> list:
    args = ["--ginc", CFG]
    for b in kitti_bindings(root) + [
            "Res16UNet.PLANES = (8, 8, 8, 8, 8, 8, 8, 8)",
            "Res16UNet.LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)",
            "train.batch_size = 2", "train.val_batch_size = 1",
            "train.train_num_workers = 1", "train.val_num_workers = 1",
            "train.max_steps = 2", "train.val_every_n_steps = 1",
            "train.log_every_n_steps = 1", 'train.loggers = ["jsonl"]']:
        args += ["--ginb", b]
    if start is not None:
        args += ["--ginb", f'train.checkpoint_path = "{start}"',
                 "--ginb", "train.load_weights = True"]
    return args + ["--seed", "3"]


def metrics(save: str) -> list:
    with open(os.path.join(save, "b2x1-Res16UNet", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_kitti_trains_in_the_port_cli(tmp_path):
    from nerf_downstream_tpu_torch.co3d_3d import train as tcli

    root = write_kitti_tree(str(tmp_path / "kitti"), np.random.default_rng(1),
                            beams=8, azimuths=256)
    save = str(tmp_path / "port")
    tcli.main(cli_args(root) + ["--save_path", save, "--device", "cpu"])
    rows = metrics(save)
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and np.isfinite(losses).all()
    val = [r for r in rows if "val/mIoU" in r]
    assert val and all(np.isfinite(r["val/loss"]) for r in val)
    assert os.path.exists(os.path.join(save, "last.ckpt"))


@pytest.mark.slow
def test_kitti_trains_in_both_clis(tmp_path):
    from co3d_3d import train as jcli
    from nerf_downstream_tpu_torch.co3d_3d import train as tcli

    root = write_kitti_tree(str(tmp_path / "kitti"), np.random.default_rng(0),
                            beams=16, azimuths=256)
    model = get_model("Res16UNet", in_channel=4, out_channel=19,
                      planes=(8,) * 8, layers=(1,) * 8)
    start = str(tmp_path / "start.ckpt")
    variables = convert.init_flax_variables(model, 5)
    tck.save_checkpoint(start, variables["params"], variables["batch_stats"])
    args = cli_args(root, start)
    saves = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jcfg.clear_config()
    jcli.main(args + ["--save_path", saves["jax"]])
    tcfg.clear_config()
    tcli.main(args + ["--save_path", saves["port"], "--device", "cpu"])
    rows = {k: metrics(save) for k, save in saves.items()}
    for key in ("train/loss", "val/loss"):
        got = {r["step"]: r[key] for r in rows["port"] if key in r}
        want = {r["step"]: r[key] for r in rows["jax"] if key in r}
        assert sorted(got) == sorted(want) and got, key
        for step, v in want.items():
            assert np.isfinite(got[step]), (key, step)
            np.testing.assert_allclose(got[step], v, rtol=1e-4,
                                       err_msg=f"{key} {step}")
