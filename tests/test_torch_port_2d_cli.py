"""The port's 2D training CLI against the JAX package's, on the CPU.

One synthetic frame tree (written by the port's own writer) and one start
checkpoint (a port training state at step 0, randomised weights) feed both
CLIs with ``co3d_2d/configs/ours_scratch_bkgd/resnet18.gin`` (background
swaps on) at 64x64 crops, ``run.precision = 32``, no dropout and one
worker, both packages' augmentation streams seeded alike: 4 steps
validating once, then the test phase. Every logged ``train/loss`` must
agree within rtol 1e-4, ``val/acc`` exactly and ``val/loss`` within 1e-4,
and ``last.ckpt``'s weights within 2e-2 of each leaf's largest entry: in
f32 a ReLU gate within rounding of zero flips in one run and not in the
other (here one moved a BatchNorm bias by 1.6 % of its leaf's largest);
``test_torch_port_2d.py`` holds the step's arithmetic to 1e-5 in f64. The
reference resumes from the port's start checkpoint, and the port then
resumes from the reference's ``last.ckpt`` at step 4
(``test_torch_port_2d.py`` holds both directions bit for bit). The other
tests hold the CLI's guards and run it alone on other configs.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.data import augmix as jaug  # noqa: E402
from nerf_downstream_tpu.data import transforms2d as JT2  # noqa: E402
from nerf_downstream_tpu.train import checkpoints as jck  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch.co3d_2d import train as tcli  # noqa: E402
from nerf_downstream_tpu_torch.data.synthetic import (  # noqa: E402
    write_perfception_2d_tree,
)
from nerf_downstream_tpu_torch.models.image import init_weights  # noqa
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from nerf_downstream_tpu_torch.train.modules2d import LitModel  # noqa: E402

CFG = "co3d_2d/configs"
RUN = "co3d_perfception_resnet18_scratch_bkgd_3"


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


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames2d_cli"))
    return write_perfception_2d_tree(root, np.random.default_rng(0),
                                     n_train=4, n_val=2, n_test=2, frames=3,
                                     size=(80, 72))


def args(p, log_dir, config="ours_scratch_bkgd/resnet18.gin", extra=()):
    out = ["--ginc", f"{CFG}/{config}"]
    for b in (
        f'PeRFCeptionCo3DTrainDataset.data_root = "{p["perfception"]}"',
        f'PeRFCeptionCo3DTrainDataset.filelist_dir = "{p["filelist"]}"',
        f'PeRFCeptionCo3DEvalDataset.data_root = "{p["perfception"]}"',
        f'PeRFCeptionCo3DEvalDataset.filelist_dir = "{p["filelist"]}"',
        f'Co3DTrainDataset.data_root = "{p["co3d"]}"',
        f'Co3DTrainDataset.filelist_dir = "{p["filelist"]}"',
        f'Co3DEvalDataset.data_root = "{p["co3d"]}"',
        f'Co3DEvalDataset.filelist_dir = "{p["filelist"]}"',
        "PeRFCeptionCo3DTrainDataset.frames_per_scene = 3",
        "RandomResizedCrop.image_size = 64", "CenterCrop.image_size = 64",
        "DataModule.batch_size = 2", "DataModule.chunks = 4",
        "DataModule.num_workers = 1", "ResNetBased.dropout_rate = 0.0",
        "run.precision = 32", "run.check_val_every_n_epoch = 1",
        "run.log_every_n_steps = 1", f'run.log_dir = "{log_dir}"',
        'run.loggers = ["csv", "jsonl"]', *extra,
    ):
        out += ["--ginb", b]
    return out + ["--seed", "3"]


def read_jsonl(log_dir):
    with open(os.path.join(log_dir, RUN, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def losses(rows):
    return {r["step"]: r["train/loss"] for r in rows if "train/loss" in r}


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def run_both(p, logs, epochs, ckpts):
    """Both CLIs, each from its checkpoint in ``ckpts`` (resumed); the
    reference's 2D streams seeded as the port's CLI seeds its own."""
    from co3d_2d import train as jcli

    out = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        for cfg in (jcfg, tcfg):
            cfg.clear_config()
        JT2.seed(3)
        jaug.seed(3)
        extra = ["--ckpt_path", ckpts[name], "--resume_training", "true"]
        if name == "port":
            extra += ["--device", "cpu"]
        out[name] = main(args(p, logs[name], extra=[
            f"run.max_epochs = {epochs}"]) + extra)
    return out


def test_cli_matches_reference_and_resumes(frames, tmp_path):
    tcfg.parse_config("ResNetBased.dropout_rate = 0.0\n")
    task = LitModel(model_name="resnet18")
    init_weights(task.model, 5)
    start = str(tmp_path / "start.ckpt")
    tck.save_training_state(start, task.create_state())
    logs = {k: str(tmp_path / k) for k in ("jax", "port")}

    results = run_both(frames, logs, 2, {"jax": start, "port": start})
    rows = {k: read_jsonl(v) for k, v in logs.items()}
    lj, lt = losses(rows["jax"]), losses(rows["port"])
    assert sorted(lt) == sorted(lj) == [1, 2, 3]
    for step in lj:
        assert np.isfinite(lt[step])
        np.testing.assert_allclose(lt[step], lj[step], rtol=1e-4)
    vj, vt = ([r for r in rows[k] if "val/acc" in r] for k in ("jax", "port"))
    assert len(vt) == len(vj) == 2  # step 2 and the test phase
    for a, b in zip(vj, vt):
        assert a["val/acc"] == b["val/acc"]
        np.testing.assert_allclose(b["val/loss"], a["val/loss"], rtol=1e-4)
    assert results["port"]["val/acc"] == results["jax"]["val/acc"]
    last = {k: os.path.join(logs[k], RUN, "last.ckpt") for k in logs}
    cj = jck.load_checkpoint(last["jax"])
    ct = tck.load_checkpoint(last["port"])
    assert ct["global_step"] == cj["global_step"] == 4
    pj, pt = dict(flat(cj["params"])), dict(flat(ct["params"]))
    assert pj.keys() == pt.keys()
    for k in pj:
        scale = float(np.abs(pj[k]).max())
        np.testing.assert_allclose(pt[k], pj[k], rtol=0, atol=2e-2 * scale,
                                   err_msg=str(k))
    for k in logs:
        assert os.path.exists(os.path.join(logs[k], RUN, "best.ckpt"))

    # the port goes on from the reference's last checkpoint (the
    # reference read the port's start checkpoint above)
    log2 = str(tmp_path / "port_resumed")
    tcfg.clear_config()
    tcli.main(args(frames, log2, extra=["run.max_epochs = 3"])
              + ["--ckpt_path", last["jax"], "--resume_training", "true",
                 "--device", "cpu"])
    assert sorted(losses(read_jsonl(log2))) == [4, 5]


@pytest.mark.parametrize("config", ["ours_scratch/resnet18.gin",
                                    "co3d_scratch/resnet18.gin",
                                    "ours_scratch/vitsmall.gin"])
def test_cli_runs_on_the_cpu(frames, tmp_path, config):
    """The port's CLI alone: rendered frames, real-CO3D frames and a ViT,
    to a written ``last.ckpt`` and a test-phase ``val/acc``."""
    res = tcli.main(args(frames, str(tmp_path), config,
                         ["run.max_epochs = 1"]) + ["--device", "cpu"])
    assert 0 <= res["val/acc"] <= 100 and np.isfinite(res["val/loss"])
    run = [d for d in os.listdir(tmp_path)][0]
    for name in ("last.ckpt", "best.ckpt", "metrics.csv"):
        assert os.path.exists(os.path.join(tmp_path, run, name))


def test_cli_guards(frames, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tcli.main(args(frames, str(tmp_path)) + ["--num_gpus", "2",
                                                 "--device", "cpu"])
    tcfg.clear_config()
    with pytest.raises(ValueError, match="precision"):
        tcli.main(args(frames, str(tmp_path), extra=["run.precision = 64"])
                  + ["--device", "cpu"])
    tcfg.clear_config()
    with pytest.raises(tcfg.ConfigError, match="LitModel.nope"):
        tcli.main(args(frames, str(tmp_path), extra=["LitModel.nope = 1"])
                  + ["--device", "cpu"])
    if not torch.cuda.is_available():
        tcfg.clear_config()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(args(frames, str(tmp_path)))


def test_precision_32_switches_tf32_off_for_the_run():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tcli.f32_without_tf32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def test_seed_restarts_the_augmentation_streams():
    from nerf_downstream_tpu_torch.data import augmix
    from nerf_downstream_tpu_torch.data import transforms2d as T2

    draws = []
    for _ in range(2):
        tcli.seed_everything(11)
        draws.append((T2._rng.random(), augmix._rng.random(),
                      np.random.random()))
    assert draws[0] == draws[1]
