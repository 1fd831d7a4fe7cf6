"""The rest of the port's single-card training surface against the JAX
package's, on the CPU.

- ``checkpoints.convert_self_supervised`` keeps and takes the same leaves
  as the reference's (``final``/``predictor`` branches, a shape that
  differs, a leaf the checkpoint lacks), exactly.
- ``transfer_self_supervised`` through the task: the port's
  ``ClassificationTraining`` and the reference's ``_maybe_load_checkpoint``
  on one checkpoint give the same weights.
- Process workers (``worker_mode = "process"``) give the same batches as
  thread workers at 2 workers, with host transforms and subsampling
  drawn per batch, and without random draws the same batches as the
  reference's DataModule at 2 workers; no worker outlives its iterator.
- ``prune_batches`` equal to the reference's (sequential train samples,
  the train collate, a capacity that subsamples).
- Logger degradation: wandb's retry loop through a stub module (the
  sleep patched), its exhaustion and its absence; tensorboard where it
  imports (an events file with the scalars) and where it does not.
"""

import functools
import multiprocessing
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.data import co3d as JCO  # noqa: E402
from nerf_downstream_tpu.data import data_module as jdm  # noqa: E402
from nerf_downstream_tpu.train import checkpoints as jck  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.data import co3d as TCO  # noqa: E402
from nerf_downstream_tpu_torch.data import data_module as tdm  # noqa: E402
from nerf_downstream_tpu_torch.data import synthetic  # noqa: E402
from nerf_downstream_tpu_torch.models.mink.resnet import (  # noqa: E402
    make_resnet,
)
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from nerf_downstream_tpu_torch.train import loggers  # noqa: E402

KEYS = ("coordinates", "features", "mask", "labels")


@pytest.fixture(autouse=True)
def _clean():
    jcfg.clear_config()
    tcfg.clear_config()
    yield
    jcfg.clear_config()
    tcfg.clear_config()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("co3d"))
    return synthetic.write_co3d_tree(root, np.random.default_rng(0),
                                     n_train=8, n_val=2, n_voxels=400,
                                     reso=(48, 48, 48), num_classes=4)


def small_model(out_channel=5):
    return make_resnet("ResNet14", 4, out_channel, planes=(4, 4, 4, 4),
                       init_dim=4, num_batches=2)


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_trees_equal(a, b):
    fa, fb = dict(flat(a)), dict(flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg="/".join(k))


def source_and_target():
    """A checkpoint's trees (a 9-class ResNet14 with a ``predictor``
    branch, one leaf of another shape, one leaf missing) and a target's
    (5 classes)."""
    target = convert.init_flax_variables(small_model(5), 0)
    raw = convert.init_flax_variables(small_model(9), 1)
    raw["params"]["predictor"] = {"kernel": np.ones((4, 3), np.float32)}
    raw["params"]["conv1"]["kernel"] = np.zeros((27, 4, 2), np.float32)
    del raw["params"]["layer4_block0"]["conv2"]
    return raw, target


def test_convert_self_supervised_matches_reference():
    raw, target = source_and_target()
    got = tck.convert_self_supervised(raw["params"], raw["batch_stats"],
                                      target["params"],
                                      target["batch_stats"])
    want = jck.convert_self_supervised(raw["params"], raw["batch_stats"],
                                       target["params"],
                                       target["batch_stats"])
    for g, w in zip(got, want):
        assert_trees_equal(g, jax.device_get(w))
    params = got[0]
    # final and the changed or missing leaves keep the target's; the rest
    # are the checkpoint's
    np.testing.assert_array_equal(params["final"]["kernel"],
                                  target["params"]["final"]["kernel"])
    np.testing.assert_array_equal(params["conv1"]["kernel"],
                                  target["params"]["conv1"]["kernel"])
    np.testing.assert_array_equal(
        params["layer4_block0"]["conv2"]["kernel"],
        target["params"]["layer4_block0"]["conv2"]["kernel"])
    np.testing.assert_array_equal(
        params["layer1_block0"]["conv1"]["kernel"],
        raw["params"]["layer1_block0"]["conv1"]["kernel"])
    assert "predictor" not in params


def test_transfer_self_supervised_through_the_task(tmp_path):
    from nerf_downstream_tpu.models import get_model as jget_model
    from nerf_downstream_tpu.train.modules import (
        ClassificationTraining as JTask,
    )
    from nerf_downstream_tpu.train.state import TrainState as JTrainState
    from nerf_downstream_tpu_torch.train.modules import (
        ClassificationTraining,
    )

    raw, target = source_and_target()
    path = str(tmp_path / "ssl.ckpt")
    tck.save_checkpoint(path, raw["params"], raw["batch_stats"])

    model = small_model(5)
    convert.load_flax_variables(model, target)
    task = ClassificationTraining(
        model, scheduler_name="none", checkpoint_path=path,
        load_weights=True, transfer_self_supervised=True)
    task.create_state()
    got = convert.state_dict_to_flax(model.state_dict(),
                                     convert.flax_layout(model))

    jmodel = jget_model(name="ResNet14", out_channel=5, num_batches=2,
                        planes=(4, 4, 4, 4), init_dim=4)
    jtask = JTask(jmodel, scheduler_name="none", checkpoint_path=path,
                  load_weights=True, transfer_self_supervised=True)
    jstate = JTrainState.create(
        jmodel.apply,
        jax.tree_util.tree_map(jnp.asarray, target["params"]),
        jax.tree_util.tree_map(jnp.asarray, target["batch_stats"]),
        jtask.make_tx())
    jstate = jtask._maybe_load_checkpoint(jstate)
    assert_trees_equal(got["params"], jax.device_get(jstate.params))
    assert_trees_equal(got["batch_stats"],
                       jax.device_get(jstate.batch_stats))


def datamodules(tree, workers, transforms=(), capacity=None,
                worker_mode="thread"):
    """The port's DataModule (with ``worker_mode``) and the reference's
    (threads: forking a process that runs XLA deadlocks its workers)."""
    data_root, fdir = tree
    out = []
    for dm, co3d, kw in ((tdm, TCO, dict(worker_mode=worker_mode)),
                         (jdm, JCO, {})):
        cls = functools.partial(co3d.Co3DDatasetBase, data_root=data_root,
                                filelist_dir=fdir,
                                train_transformations=list(transforms))
        out.append(dm.DataModule(
            batch_size=2, val_batch_size=2, train_num_workers=workers,
            val_num_workers=workers, capacity=capacity, seed=5,
            dataset_cls=cls, **kw))
    return out


def take(it, n):
    return [next(it) for _ in range(n)]


def assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in KEYS:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_process_workers_match_threads_and_reference(tree):
    # with host transforms and a capacity that subsamples: every batch
    # draws from its own generator, so the worker kind changes nothing
    aug = ("RandomFeatureJitter", "CoordinateJitter", "RandomScale")
    threads, _ = datamodules(tree, 2, aug, capacity=640)
    procs, _ = datamodules(tree, 2, aug, capacity=640,
                           worker_mode="process")
    it_t, it_p = threads.train_batches(), procs.train_batches()
    got_t, got_p = take(it_t, 6), take(it_p, 6)  # an epoch and a half
    assert_batches_equal(got_p, got_t)
    assert not np.array_equal(got_p[0]["features"], got_p[1]["features"])
    assert_batches_equal(list(procs.val_batches("val")),
                         list(threads.val_batches("val")))
    it_p.close()
    assert not multiprocessing.active_children()

    # without random draws: the reference's batches at 2 workers
    port, ref = datamodules(tree, 2, worker_mode="process")
    it = port.train_batches()
    assert_batches_equal(take(it, 6), take(ref.train_batches(), 6))
    assert_batches_equal(list(port.val_batches("val")),
                         list(ref.val_batches("val")))
    it.close()
    assert not multiprocessing.active_children()
    with pytest.raises(ValueError, match="worker_mode"):
        tdm.DataModule(worker_mode="fork")


@pytest.mark.parametrize("capacity", [None, 640])
def test_prune_batches_match_reference(tree, capacity):
    port, ref = datamodules(tree, 1, capacity=capacity)
    for args in ((2, None), (3, 3)):
        got = list(port.prune_batches(*args))
        want = list(ref.prune_batches(*args))
        assert len(got) == args[0]
        assert_batches_equal(got, want)
    # past the end of the train samples: as many groups as fit
    assert len(list(port.prune_batches(9, 3))) == len(
        list(ref.prune_batches(9, 3))) == 3


def stub_wandb(fail_times: int, calls: dict):
    mod = types.ModuleType("wandb")

    class Run:
        config = types.SimpleNamespace(
            update=lambda d, **k: calls.setdefault("config", []).append(d))

        def log(self, d, step=None):
            calls.setdefault("logged", []).append((step, d))

        def finish(self):
            calls["finished"] = True

    def init(**kwargs):
        calls["attempts"] = calls.get("attempts", 0) + 1
        if calls["attempts"] <= fail_times:
            raise ConnectionError("flaky backend")
        calls["init_kwargs"] = kwargs
        return Run()

    mod.init = init
    return mod


def test_wandb_logger_retries_and_degrades(monkeypatch, tmp_path):
    waits = []
    monkeypatch.setattr(loggers.time, "sleep", waits.append)
    calls = {}
    monkeypatch.setitem(sys.modules, "wandb", stub_wandb(3, calls))
    lg = loggers.get_logger("wandb", str(tmp_path), "run", "proj")
    assert isinstance(lg, loggers.RetryingWandbLogger) and lg.active
    assert calls["attempts"] == 4 and waits == [5.0] * 3
    assert calls["init_kwargs"] == dict(project="proj", name="run",
                                        dir=str(tmp_path), reinit=True)
    lg.log_metrics({"loss": np.float32(1.5)}, step=7)
    lg.log_hyperparams({"lr": 0.1})
    lg.finalize()
    assert calls["logged"] == [(7, {"loss": 1.5})] and calls["finished"]

    # retries exhausted (the reference's 100 x 5 s): logging is off
    calls, waits[:] = {}, []
    monkeypatch.setitem(sys.modules, "wandb", stub_wandb(10 ** 6, calls))
    lg = loggers.get_logger("wandb", str(tmp_path))
    assert calls["attempts"] == 100 and waits == [5.0] * 100
    assert not lg.active
    lg.log_metrics({"loss": 1.0}, step=0)
    lg.finalize()

    # wandb absent: a warning, logging off
    monkeypatch.setitem(sys.modules, "wandb", None)
    lg = loggers.get_logger("wandb", str(tmp_path))
    assert not lg.active
    lg.log_metrics({"x": 1.0}, step=0)


def test_tensorboard_logger_writes_or_degrades(monkeypatch, tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    lg = loggers.get_logger("tensorboard", str(tmp_path), "run")
    assert isinstance(lg, loggers.TensorBoardLogger) and lg.active
    lg.log_metrics({"train/loss": np.float32(2.5), "note": "text"}, step=3)
    lg.finalize()
    files = os.listdir(tmp_path / "run")
    assert any(f.startswith("events.out.tfevents") for f in files)
    from tensorboard.backend.event_processing import event_accumulator

    acc = event_accumulator.EventAccumulator(str(tmp_path / "run"))
    acc.Reload()
    (event,) = acc.Scalars("train/loss")
    assert (event.step, event.value) == (3, 2.5)

    # where torch.utils.tensorboard cannot be imported
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = loggers.get_logger("tb", str(tmp_path / "off"))
    assert not lg.active
    lg.log_metrics({"train/loss": 1.0}, step=0)
    lg.finalize()
