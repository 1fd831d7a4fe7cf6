"""The port's ModelNet40 slice (``modelnet40_cls.gin``, MinkowskiFCNN)
against the JAX package's, on the CPU, at small widths (FCNN channels
(8, 8, 8, 8, 8), embedding 64) on HDF5 trees the tests write with h5py.

- ``ModelNet40H5Dataset``: train and val samples under the config's
  transform list from streams seeded alike, exactly equal; the ``arrays``
  constructor equal to the file read.
- MinkowskiFCNN and MinkowskiSplatFCNN eval logits within 1e-5 x
  max|logit|, and the eval step's loss within 1e-5.
- One ``ClassificationTraining`` SGD step (lr 0.1, momentum 0.9) with the
  reference's own dropout mask, captured from its ``nn.Dropout`` with
  ``flax.linen.intercept_methods`` and carried into the port: the loss,
  each gradient and each updated weight and statistic (relative to the
  leaf's largest entry) within 1e-5, or within twice the reference's own
  spread between two XLA optimization levels where that is larger,
  measured in the test (as ``test_torch_port_cls_bottleneck.py`` does):
  most leaves move by 1e-4 or more there. The conv biases' gradients,
  which a train-mode BatchNorm cancels (zero in exact arithmetic), are
  rounding in both packages: each is held below 1e-5 of its kernel's
  largest gradient instead. The batch
  keeps one point per voxel and binds ``field_to_sparse.assume_unique``:
  the duplicate averaging's f32 error, about 4e-5 of the largest voxel
  feature, moves with any change of its inputs (ROADMAP Queue 3), and
  through the max poolings it flips single gradient entries. The training states after the step go both ways bit
  for bit: the port's through the reference's ``restore_into``, the
  reference's through the port's.
- The training CLIs on ``modelnet40_cls.gin`` from one port-written start
  checkpoint, with the config's val batch smaller than its train batch:
  both train on equal batches; the reference's CLI raises at its first
  validation (its loss needs the two batch sizes equal), the port's drops
  the spare scene slots and completes. The two eval CLIs on the port's
  last checkpoint agree within 1e-5 relative. The port's run resumes, its
  weights and momentum buffers restored bit for bit.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.data import modelnet40 as JMN  # noqa: E402
from nerf_downstream_tpu.data import transforms as JT  # noqa: E402
from nerf_downstream_tpu.models import get_model as jget_model  # noqa: E402
from nerf_downstream_tpu.train import checkpoints as jck  # noqa: E402
from nerf_downstream_tpu.train import modules as jmod  # noqa: E402
from nerf_downstream_tpu.train.state import (  # noqa: E402
    TrainState as JTrainState,
)
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.data import modelnet40 as TMN  # noqa: E402
from nerf_downstream_tpu_torch.data import transforms as TT  # noqa: E402
from nerf_downstream_tpu_torch.data.synthetic import (  # noqa: E402
    collate_mink,
    write_modelnet40_tree,
)
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from nerf_downstream_tpu_torch.train import modules as tmod  # noqa: E402

FCNN = convert.FlaxLayout("fcnn")  # the FCNNs' trees

CFG = "co3d_3d/configs/modelnet40_cls.gin"
SMALL = dict(channels=(8, 8, 8, 8, 8), embedding_channel=64)
CLOUDS, POINTS = 4, 512
KEYS = ("coordinates", "features", "mask", "labels")
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _setup():
    jcfg.clear_config()
    tcfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jcfg.clear_config()
    tcfg.clear_config()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_modelnet40_tree(str(tmp_path_factory.mktemp("modelnet")),
                                 np.random.default_rng(0), n_train=8,
                                 n_test=4)


def close_to_largest(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def bind_config(tree, *extra):
    lines = [f'ModelNet40H5Dataset.data_root = "{tree}"', *extra]
    for cfg in (jcfg, tcfg):
        cfg.parse_config_files_and_bindings([CFG], lines)


# -- the dataset -------------------------------------------------------------

def test_dataset_matches_reference(tree):
    bind_config(tree)
    for phase, n in (("train", 8), ("val", 4)):
        JT.seed(5)
        TT.seed(5)
        ref, ours = JMN.ModelNet40H5Dataset(phase), TMN.ModelNet40H5(phase)
        assert len(ours) == len(ref) == n
        data, label = TMN.ModelNet40H5Dataset.load(
            tree, "train" if phase == "train" else "test")
        TT.seed(5)
        twin = TMN.ModelNet40H5Dataset(phase, arrays=(data, label))
        got = [ours[i] for i in range(n)]
        TT.seed(5)
        for i in range(n):
            a, b, c = ref[i], got[i], twin[i]
            for k in ("coordinates", "features", "labels"):
                assert b[k].dtype == a[k].dtype, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                np.testing.assert_array_equal(c[k], a[k], err_msg=k)
            assert b["labels"].shape == (1,)
            assert b["labels"][0] == label[i, 0]
            # the train pipeline moves the points; val keeps them
            raw = np.array_equal(b["features"], data[i])
            assert raw == (phase == "val")
            np.testing.assert_allclose(b["coordinates"] * 0.05,
                                       b["features"], rtol=1e-6)


# -- the models --------------------------------------------------------------

def batch_of(tree, phase="train", seed=3, unique=False):
    """A collated batch of CLOUDS samples of the phase; ``unique`` keeps
    one point per voxel and binds ``field_to_sparse.assume_unique``."""
    bind_config(tree, f"ModelNet40H5Dataset.num_points = {POINTS}",
                f"field_to_sparse.assume_unique = {unique}")
    TT.seed(seed)
    ds = TMN.ModelNet40H5Dataset(phase)
    samples = [ds[i] for i in range(CLOUDS)]
    if unique:
        for s in samples:
            _, first = np.unique(np.floor(s["coordinates"]), axis=0,
                                 return_index=True)
            first.sort()
            s["coordinates"] = s["coordinates"][first]
            s["features"] = s["features"][first]
    batch = collate_mink(samples, capacity=4096)
    assert (batch["coordinates"][batch["mask"], 1:] < 0).any()
    return batch


def models(name):
    jmodel = jget_model(name=name, in_channel=3, out_channel=40,
                        num_batches=CLOUDS, **SMALL)
    model = get_model(name, in_channel=3, out_channel=40,
                      num_batches=CLOUDS, **SMALL)
    variables = convert.init_flax_variables(model, 1)
    convert.load_flax_variables(model, variables)
    return jmodel, model, variables


def jstate_of(jmodel, variables, tx):
    return JTrainState.create(
        jmodel.apply,
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), tx)


def tensors(batch):
    out = {k: torch.as_tensor(batch[k]) for k in
           ("coordinates", "features", "mask")}
    out["labels"] = torch.as_tensor(batch["labels"]).long()
    return out


@pytest.mark.parametrize("name", ["MinkowskiFCNN", "MinkowskiSplatFCNN"])
def test_fcnn_eval_matches_reference(tree, name):
    batch = batch_of(tree, "val")
    jmodel, model, variables = models(name)
    jtask = jmod.ClassificationTraining(jmodel, scheduler_name="none")
    state = jstate_of(jmodel, variables, jtask.make_tx())
    jb = {k: jnp.asarray(batch[k]) for k in
          ("coordinates", "features", "mask", "labels")}
    ref, ref_mets = jtask.make_eval_step().lower(state, jb).compile(
        compiler_options=FAST_XLA)(state, jb)
    task = tmod.ClassificationTraining(model, scheduler_name="none")
    logits, mets = task.eval_step(task.create_state(), tensors(batch))
    assert logits.shape == (CLOUDS, 40)
    close_to_largest(logits.numpy(), np.asarray(ref), 1e-5, "logits")
    np.testing.assert_allclose(float(mets["loss"]), float(ref_mets["loss"]),
                               rtol=1e-5)
    routes = {m.route for m in model.modules() if hasattr(m, "route")}
    assert routes == {"row"}


class FixedDropout(torch.nn.Module):
    """flax's dropout at rate 0.5 with a given keep mask."""

    def __init__(self, keep):
        super().__init__()
        self.keep = torch.as_tensor(keep)

    def forward(self, x, generator):
        return torch.where(self.keep, x / 0.5, 0.0)


def test_fcnn_step_with_reference_dropout_matches(tree, tmp_path):
    batch = batch_of(tree, unique=True)
    jmodel, model, variables = models("MinkowskiFCNN")
    for cfg in (jcfg, tcfg):
        cfg.parse_config("SGD.momentum = 0.9\n")
    jtask = jmod.ClassificationTraining(jmodel, scheduler_name="none",
                                        lr=0.1)
    stash = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    jstate = jstate_of(jmodel, variables, optax.chain(stash, jtask.make_tx()))
    jb = {k: jnp.asarray(batch[k]) for k in
          ("coordinates", "features", "mask", "labels")}
    seen = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            jax.debug.callback(
                lambda x, y: seen.append((np.asarray(x), np.asarray(y))),
                args[0], out)
        return out

    def reference_step(options):
        with fnn.intercept_methods(capture):
            step = jtask.make_train_step(donate=False).lower(
                jstate, jb).compile(compiler_options=options)
        rs, rm = step(jstate, jb)
        jax.effects_barrier()
        grads = convert.flax_to_state_dict(model,
                                           jax.device_get(rs.opt_state[0]))
        after = convert.flax_to_state_dict(model, {
            "params": jax.device_get(rs.params),
            "batch_stats": jax.device_get(rs.batch_stats)})
        return rs, float(rm["loss"]), grads, after

    rs, ref_loss, ref_grads, ref_after = reference_step(FAST_XLA)
    # the reference's own spread: its step at XLA's default optimization
    _, alt_loss, alt_grads, alt_after = reference_step({})
    (x, y), (_, y2) = seen
    assert (x != 0).all() and np.array_equal(y != 0, y2 != 0)
    keep = y != 0
    assert 0.3 < keep.mean() < 0.7
    spread = {("loss",): abs(alt_loss - ref_loss) / abs(ref_loss)}
    for kind, ref, alt in (("grad", ref_grads, alt_grads),
                           ("after", ref_after, alt_after)):
        for k in ref:
            spread[kind, k] = float((ref[k] - alt[k]).abs().max()
                                    / ref[k].abs().max().clamp(min=1e-30))

    def limit(*key):
        return max(1e-5, 2 * spread[key])

    model.dropout = FixedDropout(keep)
    task = tmod.ClassificationTraining(model, scheduler_name="none", lr=0.1)
    state = task.create_state()
    state, mets = task.train_step(state, tensors(batch))
    np.testing.assert_allclose(float(mets["loss"]), ref_loss,
                               rtol=limit("loss"))
    for key, p in model.named_parameters():
        if key.endswith("conv.bias"):
            # ahead of a train-mode BatchNorm: zero in exact arithmetic,
            # rounding in both packages; held to its kernel's gradients
            scale = float(ref_grads[key[:-4] + "kernel"].abs().max())
            assert float(p.grad.abs().max()) <= 1e-5 * scale, key
            assert float(ref_grads[key].abs().max()) <= 1e-5 * scale, key
            continue
        close_to_largest(p.grad.numpy(), ref_grads[key].numpy(),
                         limit("grad", key), key)
    for key, v in model.state_dict().items():
        close_to_largest(v.numpy(), ref_after[key].numpy(),
                         limit("after", key), key)

    # the training states after the step, both ways bit for bit
    path = str(tmp_path / "port.ckpt")
    tck.save_training_state(path, state)
    bare = jstate_of(jmodel, variables, jtask.make_tx())
    back = jck.restore_into(jax.tree_util.tree_map(jnp.zeros_like, bare),
                            jck.load_checkpoint(path), weights=True,
                            optimizer=True)
    want = convert.state_dict_to_flax(model.state_dict(), FCNN)
    trace = convert.state_dict_to_flax(
        {n: state.optimizer.state[p]["momentum_buffer"]
         for n, p in model.named_parameters()}, FCNN)["params"]
    for a, b in zip(jax.tree_util.tree_leaves((want["params"],
                                               want["batch_stats"], trace)),
                    jax.tree_util.tree_leaves((back.params,
                                               back.batch_stats,
                                               back.opt_state[1][0].trace))):
        np.testing.assert_array_equal(np.asarray(b), a)
    jstate2 = rs.replace(opt_state=rs.opt_state[1], tx=jtask.make_tx())
    jpath = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(jpath, jstate2)
    other = get_model("MinkowskiFCNN", in_channel=3, out_channel=40,
                      num_batches=CLOUDS, **SMALL)
    ostate = tmod.ClassificationTraining(other, scheduler_name="none",
                                         lr=0.1).create_state()
    tck.restore_into(ostate, tck.load_checkpoint(jpath), weights=True,
                     optimizer=True)
    got = convert.state_dict_to_flax(other.state_dict(), FCNN)
    bufs = convert.state_dict_to_flax(
        {n: ostate.optimizer.state[p]["momentum_buffer"]
         for n, p in other.named_parameters()}, FCNN)["params"]
    for a, b in zip(jax.tree_util.tree_leaves((got["params"],
                                               got["batch_stats"], bufs)),
                    jax.tree_util.tree_leaves((rs.params, rs.batch_stats,
                                               rs.opt_state[1][1][0].trace))):
        np.testing.assert_array_equal(a, np.asarray(b))


# -- the CLIs ----------------------------------------------------------------

def test_training_and_eval_clis_match_reference(tree, tmp_path):
    from co3d_3d import eval as jeval
    from co3d_3d import train as jcli
    from nerf_downstream_tpu_torch.co3d_3d import eval as teval
    from nerf_downstream_tpu_torch.co3d_3d import train as tcli

    model = get_model("MinkowskiFCNN", in_channel=3, out_channel=40, **SMALL)
    start = str(tmp_path / "start.ckpt")
    tree0 = convert.init_flax_variables(model, 5)
    tck.save_checkpoint(start, tree0["params"], tree0["batch_stats"])
    binds = [f'ModelNet40H5Dataset.data_root = "{tree}"',
             f"ModelNet40H5Dataset.num_points = {POINTS}",
             "get_model.channels = (8, 8, 8, 8, 8)",
             "get_model.embedding_channel = 64",
             "train.batch_size = 4", "train.val_batch_size = 2",
             "train.train_num_workers = 1", "train.val_num_workers = 1",
             "train.val_every_n_steps = 2", "train.log_every_n_steps = 1",
             'train.loggers = ["jsonl"]']
    run = binds + [f'train.checkpoint_path = "{start}"',
                   "train.load_weights = True"]

    def argv(bindings, steps):
        out = ["--ginc", CFG]
        for b in bindings + [f"train.max_steps = {steps}"]:
            out += ["--ginb", b]
        return out + ["--seed", "3"]

    seen = {"jax": [], "port": []}
    make = jmod.BaseTask.make_train_step

    def recording_make(self, donate=True):
        fn = make(self, donate)

        def step(state, batch):
            seen["jax"].append({k: np.asarray(batch[k]) for k in KEYS})
            return fn(state, batch)
        return step

    step = tmod.BaseTask.train_step

    def recording_step(self, state, batch):
        seen["port"].append({k: batch[k].cpu().numpy() for k in KEYS})
        return step(self, state, batch)

    jmod.BaseTask.make_train_step = recording_make
    tmod.BaseTask.train_step = recording_step
    try:
        jcfg.clear_config()
        with pytest.raises(ValueError, match="Incompatible shapes"):
            jcli.main(argv(run, 3) + ["--save_path", str(tmp_path / "jax")])
        tcfg.clear_config()
        tcli.main(argv(run, 3) + ["--save_path", str(tmp_path / "port"),
                                  "--device", "cpu"])
    finally:
        jmod.BaseTask.make_train_step = make
        tmod.BaseTask.train_step = step
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for a, b in zip(seen["port"], seen["jax"]):
        for k in KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rows = [json.loads(line) for line in open(
        tmp_path / "port" / "b4x1-MinkowskiFCNN" / "metrics.jsonl")]
    assert any("val/acc1" in r for r in rows)
    assert all(np.isfinite(r["train/loss"]) for r in rows
               if "train/loss" in r)

    # the eval CLIs on the port's last checkpoint, at equal batch sizes
    last = str(tmp_path / "port" / "last.ckpt")
    eargs = argv(binds + ["train.val_batch_size = 4",
                          "evaluate.val_batch_size = 4"], 3)
    eargs += ["--load_path", last, "--tag", "mn",
              "--training_module", "ClassificationTraining"]
    jcfg.clear_config()
    want = jeval.main(eargs + ["--save_path", str(tmp_path / "jeval")])
    tcfg.clear_config()
    got = teval.main(eargs + ["--save_path", str(tmp_path / "teval"),
                              "--device", "cpu"])
    for k in ("val/acc1", "val/acc5", "val/loss"):
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)

    # a resume restores the weights and momentum buffers bit for bit
    saved = tck.load_checkpoint(last)
    restored = {}
    restore = tck.restore_into

    def recording_restore(state, raw, **kw):
        out = restore(state, raw, **kw)
        if kw.get("optimizer"):
            restored["params"] = convert.state_dict_to_flax(
                state.model.state_dict(), FCNN)["params"]
            restored["trace"] = convert.state_dict_to_flax(
                {n: state.optimizer.state[p]["momentum_buffer"]
                 for n, p in state.model.named_parameters()}, FCNN)["params"]
        return out

    tck.restore_into = recording_restore
    try:
        tcfg.clear_config()
        tcli.main(argv(run, 4) + ["--save_path", str(tmp_path / "port"),
                                  "--device", "cpu", "--resume"])
    finally:
        tck.restore_into = restore
    assert tck.load_checkpoint(last)["global_step"] == 4
    trace = saved["opt_state"]["1"]["0"]["trace"]
    for a, b in zip(jax.tree_util.tree_leaves((saved["params"], trace)),
                    jax.tree_util.tree_leaves((restored["params"],
                                               restored["trace"]))):
        np.testing.assert_array_equal(b, a)
