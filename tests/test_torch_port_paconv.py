"""The port's PAConv slice (``co3d_3d/paconv_train.py``: PAConvPointNet,
PAConvDGCNN, DGCNN and PointNet on dense ModelNet40 clouds, and
MinkowskiPointNet) against the JAX package's, on the CPU, at small sizes
(k 4, num_matrices 2 per layer, 64 points, embedding 64). Every input is
made from a seed with numpy.

- Assign-score, both variants: forward and backward against the
  reference's custom VJP and against the naive versions of both
  packages, within 1e-5 of the largest value.
- kNN: indices equal to the reference's, on a cloud with duplicate
  points too (ties keep the lower index first, as ``lax.top_k``).
- Eval-mode logits of the six models within 1e-5 x max|logit|, the
  eval step's loss within 1e-5 relative.
- One SGD step (lr 0.1, momentum 0.9, weight decay 1e-4) of PAConvDGCNN
  and DGCNN_cls on 8 clouds with the reference's own dropout masks,
  captured from its ``nn.Dropout`` calls with
  ``flax.linen.intercept_methods``, and its kNN graphs carried into the
  port: the loss, every gradient and every updated weight and statistic
  within 1e-5 of the leaf's largest entry, or within twice the
  reference's own spread under a one-ulp change of its inputs where that
  is larger (``test_step_with_reference_dropout_matches``).
- Training states both ways bit for bit for each family: the port's
  through the reference's ``restore_into``, the reference's through the
  port's.
- The gin surface: ``PAConvPointNet.k = 8`` binds in the port (the
  reference accepts the binding and ignores it).
- The training CLIs (``paconv_train``, PAConvDGCNN) on a tiny HDF5 tree
  from one port-written start checkpoint
  (``ClassificationTraining.load_weights`` and ``.checkpoint_path``
  bindings, in both; no dropout, whose masks the packages draw from
  different generators): equal batch streams, the validation metrics
  within 1e-5 relative, and a resume of the port's run restoring weights
  and momentum bit for bit. The CLIs run at ``--lr 0``, so that their
  steps update the BatchNorm statistics and the momentum but not the
  weights: on these synthetic clouds the reference's own step moves by up
  to 1e-2 of a leaf's largest gradient when its inputs move by one ulp
  (the max over each cloud's points has values within rounding of each
  other), so trained weights, and the validation after them, agree only
  as far as that spread (measured 7e-5 relative on the val loss at lr
  1e-4); the steps themselves are held by the step test above. The
  optimizers the two CLIs built take two steps on the same gradients,
  their momentum traces within 1e-6 (momentum and weight decay); and
  the port's CLI at ``--lr 0.1`` with ``--max_steps`` one past its epoch
  applies, step by step, the reference's cosine over the CLI's epochs
  (from each step's update and momentum buffer, within 1e-4).
"""

import contextlib
import csv
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from co3d_3d import paconv_train as jcli  # noqa: E402
from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.models import get_model as jget_model  # noqa: E402
from nerf_downstream_tpu.models import paconv as jpaconv  # noqa: E402
from nerf_downstream_tpu.models.mink import dgcnn as jdgcnn  # noqa: E402
from nerf_downstream_tpu.ops import paconv as jops  # noqa: E402
from nerf_downstream_tpu.train import checkpoints as jck  # noqa: E402
from nerf_downstream_tpu.train import modules as jmod  # noqa: E402
from nerf_downstream_tpu.train.state import (  # noqa: E402
    TrainState as JTrainState,
)
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.co3d_3d import paconv_train as tcli  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.models import paconv  # noqa: E402
from nerf_downstream_tpu_torch.models.mink import dgcnn  # noqa: E402
from nerf_downstream_tpu_torch.ops import paconv as ops  # noqa: E402
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from nerf_downstream_tpu_torch.train import modules as tmod  # noqa: E402

B, N, K = 4, 64, 4
# the training step's batch: at 4 clouds the train-mode BatchNorms of
# PAConvDGCNN's head make a few ScoreNet leaves move by up to 3x more
# between the packages than the reference's own one-ulp spread
STEP_B = 8
SMALL = {
    "PAConvPointNet": dict(k=K, num_matrices=(2, 2, 2)),
    "PAConvDGCNN": dict(k=K, num_matrices=(2, 2, 2, 2)),
    "DGCNN_cls": dict(k=K, emb_dims=64),
    "DGCNN_semseg": dict(k=K, emb_dims=64),
    "PointNet": dict(embedding_channel=64),
    "MinkowskiPointNet": dict(embedding_channel=64, num_batches=B),
}
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


def close_to_largest(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def cloud(seed=0, b=B, n=N):
    return np.random.default_rng(seed).normal(size=(b, n, 3)).astype(
        np.float32)


# -- assign-score --------------------------------------------------------------

@pytest.mark.parametrize("centers", [True, False], ids=["full", "half"])
def test_assign_score_matches_reference(centers):
    rng = np.random.default_rng(1)
    b, n, np_, k, m, o = 2, 12, 10, 3, 4, 5
    arrays = [rng.normal(size=(b, n, k, m)), rng.normal(size=(b, np_, m, o)),
              rng.normal(size=(b, n, m, o))]
    arrays = [a.astype(np.float32) for a in arrays]
    idx = rng.integers(0, np_, (b, n, k)).astype(np.int32)
    g = rng.normal(size=(b, n, o)).astype(np.float32)
    if not centers:
        arrays = arrays[:2]

    def jfn(*xs):
        if centers:
            return jops.assign_score_withk(*xs, jnp.asarray(idx))
        return jops.assign_score_withk_halfkernel(*xs, jnp.asarray(idx))

    def jnaive(*xs):
        return jops.assign_score_withk_reference(
            xs[0], xs[1], xs[2] if centers else None, jnp.asarray(idx))

    jx = [jnp.asarray(a) for a in arrays]

    def value_and_vjp(fn):
        def run(xs, gg):
            out, vjp = jax.vjp(fn, *xs)
            return out, vjp(gg)
        return jax.jit(run).lower(jx, g).compile(
            compiler_options=FAST_XLA)(jx, g)

    want, want_g = value_and_vjp(jfn)
    naive, naive_g = value_and_vjp(jnaive)
    for ref, ref_g in ((want, want_g), (naive, naive_g)):
        for fn in ("fast", "naive"):
            tx = [torch.tensor(a, requires_grad=True) for a in arrays]
            ti = torch.as_tensor(idx)
            if fn == "fast" and centers:
                out = ops.assign_score_withk(*tx, ti)
            elif fn == "fast":
                out = ops.assign_score_withk_halfkernel(*tx, ti)
            else:
                out = ops.assign_score_withk_reference(
                    tx[0], tx[1], tx[2] if centers else None, ti)
            out.backward(torch.as_tensor(g))
            close_to_largest(out.detach().numpy(), ref, 1e-5, fn)
            for name, t, r in zip(("scores", "points", "centers"), tx,
                                  ref_g):
                close_to_largest(t.grad.numpy(), r, 1e-5, f"{fn} d_{name}")


# -- kNN -----------------------------------------------------------------------

@pytest.mark.parametrize("duplicates", [False, True])
def test_knn_matches_reference(duplicates):
    x = cloud(2)
    if duplicates:
        # every point of the second half repeats one of the first half, so
        # each point's own distance ties with its twin's
        x[:, N // 2:] = x[:, :N // 2][:, np.random.default_rng(3).permutation(
            N // 2)]
    want = np.asarray(jdgcnn.knn(jnp.asarray(x), 8))
    got = dgcnn.knn(torch.as_tensor(x), 8).numpy()
    np.testing.assert_array_equal(got, want)
    if duplicates:
        # ties: the lower index comes first
        twin = got[:, N // 2:, :2]
        assert (twin[..., 0] < twin[..., 1]).all()
        # feature-space graphs too (DGCNN's later edge convs)
        f = np.random.default_rng(4).normal(size=(B, N, 16)).astype(
            np.float32)
        f[:, 1::2] = f[:, ::2]
        np.testing.assert_array_equal(
            dgcnn.knn(torch.as_tensor(f), K).numpy(),
            np.asarray(jdgcnn.knn(jnp.asarray(f), K)))


# -- the models ----------------------------------------------------------------

class JDGCNN_cls(jdgcnn.DGCNN_cls):
    """The reference's DGCNN_cls with the ``out_channel`` its tasks read
    (its module names the field ``output_channels``, so its
    ``ClassificationTraining`` raises on it; ROADMAP Queue 3)."""

    @property
    def out_channel(self):
        return self.output_channels


def models(name, seed=1):
    if name == "DGCNN_cls":
        jmodel = JDGCNN_cls(output_channels=40, **SMALL[name])
    else:
        jmodel = jget_model(name=name, in_channel=3, out_channel=40,
                            **SMALL[name])
    model = get_model(name, in_channel=3, out_channel=40, **SMALL[name])
    variables = convert.init_flax_variables(model, seed)
    convert.load_flax_variables(model, variables)
    return jmodel, model, variables


def jstate_of(jmodel, variables, tx):
    return JTrainState.create(
        jmodel.apply,
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), tx)


def field_batch(seed=5):
    """B clouds of N points as one point field (MinkowskiPointNet's
    input), with padding rows."""
    pts = cloud(seed)
    rows = B * N + 16
    coords = np.zeros((rows, 4), np.float32)
    feats = np.zeros((rows, 3), np.float32)
    for b in range(B):
        coords[b * N:(b + 1) * N, 0] = b
        coords[b * N:(b + 1) * N, 1:] = pts[b] * 20
        feats[b * N:(b + 1) * N] = pts[b]
    return {"coordinates": coords, "features": feats,
            "mask": np.arange(rows) < B * N,
            "labels": np.random.default_rng(seed).integers(
                0, 40, B).astype(np.int32)}


def dense_batch(seed=5, b=B):
    x = cloud(seed, b) * 20  # coordinates in voxels, as ModelNet40H5Dataset's
    return {"coordinates": x, "features": x / 20,
            "mask": np.ones(b, bool),
            "labels": np.random.default_rng(seed).integers(
                0, 40, b).astype(np.int32)}


def tasks(name, jmodel, model, **kw):
    if name == "MinkowskiPointNet":
        return (jmod.ClassificationTraining(jmodel, **kw),
                tmod.ClassificationTraining(model, **kw))
    return jcli.DensePointTask(jmodel, **kw), tcli.DensePointTask(model, **kw)


def tensors(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["labels"] = out["labels"].long()
    return out


@pytest.mark.parametrize("name", list(SMALL))
def test_model_eval_matches_reference(name):
    batch = (field_batch() if name == "MinkowskiPointNet" else dense_batch())
    jmodel, model, variables = models(name)
    if name == "DGCNN_semseg":
        # per-point logits: no classification task
        x = batch["coordinates"]
        fwd = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))
        ref = fwd.lower(variables, x).compile(compiler_options=FAST_XLA)(
            variables, x)
        got = model.eval()(torch.as_tensor(x))
        assert got.shape == (B, N, 40)
        close_to_largest(got.detach().numpy(), np.asarray(ref), 1e-5)
        return
    jtask, task = tasks(name, jmodel, model, scheduler_name="none")
    state = jstate_of(jmodel, variables, jtask.make_tx())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, ref_mets = jtask.make_eval_step().lower(state, jb).compile(
        compiler_options=FAST_XLA)(state, jb)
    logits, mets = task.eval_step(task.create_state(), tensors(batch))
    assert logits.shape == (B, 40)
    close_to_largest(logits.numpy(), np.asarray(ref), 1e-5, "logits")
    np.testing.assert_allclose(float(mets["loss"]), float(ref_mets["loss"]),
                               rtol=1e-5)


class FixedDropout(torch.nn.Module):
    """flax's dropout at rate 0.5 with a given keep mask."""

    def __init__(self, keep):
        super().__init__()
        self.keep = torch.as_tensor(keep)

    def forward(self, x, generator):
        return torch.where(self.keep, x / 0.5, 0.0)


@pytest.mark.parametrize("name,dtype", [("PAConvDGCNN", "float32"),
                                        ("DGCNN_cls", "float64")])
def test_step_with_reference_dropout_matches(name, dtype, monkeypatch,
                                             request):
    """One SGD step on a batch of STEP_B clouds, with the reference's
    dropout masks and kNN graphs carried into the port. Each leaf within
    1e-5 of its largest entry, or within twice the reference's own spread
    where that is larger: the most its own step moves when every input
    coordinate moves by one ulp up or down (these models stack train-mode
    BatchNorms over a few clouds, and their leaves move by up to 1e-4
    under such a change). The bias ahead of a train-mode BatchNorm
    (``linear2.bias``: zero in exact arithmetic, rounding in both
    packages) is held below 1e-5 of its kernel's largest gradient. The
    port's own graphs agree with the carried ones on all but a few
    entries: the coordinate graph exactly, the feature-space graphs of
    DGCNN's later edge convs up to near-ties that the two packages'
    rounding of the same features can order either way.

    DGCNN_cls runs in f64 in both packages (its input, loss and the
    coordinate graph in f32, as both compute them): in f32 its max over
    each point's neighbours has values within rounding of each other now
    and then (at 8 clouds here), which the two packages pick differently,
    moving its edge convs' gradients by 1e-4 (measured). PAConvDGCNN's
    assign-score accumulates in f32 in both, so it runs in f32."""
    batch = dense_batch(6, STEP_B)
    jmodel, model, variables = models(name, 2)
    if dtype == "float64":
        model.double()
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables)
        x64 = contextlib.ExitStack()
        request.addfinalizer(x64.close)
        x64.enter_context(jax.enable_x64(True))
    for cfg in (jcfg, tcfg):
        cfg.parse_config("SGD.momentum = 0.9\n")
    kw = dict(scheduler_name="none", lr=0.1, weight_decay=1e-4)
    jtask, task = tasks(name, jmodel, model, **kw)
    stash = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    jstate = jstate_of(jmodel, variables, optax.chain(stash, jtask.make_tx()))
    masks, graphs = {}, {}

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            key = context.module.name
            jax.debug.callback(
                lambda y: masks.setdefault(key, np.asarray(y) != 0), out)
        return out

    knn = jdgcnn.knn

    def recording_knn(x, k):
        idx = knn(x, k)
        i = len(graphs)
        graphs[i] = None
        jax.debug.callback(
            lambda v: graphs.__setitem__(i, graphs[i] if graphs[i] is not None
                                         else np.asarray(v)), idx)
        return idx

    monkeypatch.setattr(jdgcnn, "knn", recording_knn)
    monkeypatch.setattr(jpaconv, "knn", recording_knn)
    with fnn.intercept_methods(capture):
        step = jtask.make_train_step(donate=False).lower(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}).compile(
                compiler_options=FAST_XLA)

    def reference_step(coords):
        jb = {k: jnp.asarray(v) for k, v in dict(batch,
                                                  coordinates=coords).items()}
        rs, rm = step(jstate, jb)
        jax.effects_barrier()
        return rs, float(rm["loss"]), convert.flax_to_state_dict(
            model, jax.device_get(rs.opt_state[0])), convert.flax_to_state_dict(
            model, {"params": jax.device_get(rs.params),
                    "batch_stats": jax.device_get(rs.batch_stats)})

    rs, ref_loss, ref_grads, ref_after = reference_step(batch["coordinates"])
    spread = {}
    for toward in (np.inf, -np.inf):
        _, loss, grads, after = reference_step(
            np.nextafter(batch["coordinates"], toward).astype(np.float32))
        spread["loss"] = max(spread.get("loss", 0.0),
                             abs(loss - ref_loss) / abs(ref_loss))
        for kind, ref, alt in (("grad", ref_grads, grads),
                               ("after", ref_after, after)):
            for k in ref:
                spread[kind, k] = max(spread.get((kind, k), 0.0), float(
                    (ref[k] - alt[k]).abs().max()
                    / ref[k].abs().max().clamp(min=1e-30)))

    def limit(*key):
        return max(1e-5, 2 * spread[key if len(key) > 1 else key[0]])

    assert sorted(masks) == ["Dropout_0", "Dropout_1"]
    for i, key in enumerate(sorted(masks)):
        assert 0.3 < masks[key].mean() < 0.7
        setattr(model, f"dropout{i + 1}", FixedDropout(masks[key]))
    carried = [torch.tensor(graphs[i]).long() for i in sorted(graphs)]
    assert len(carried) == (1 if name == "PAConvDGCNN" else 4)
    own, port_knn = [], dgcnn.knn

    def carried_knn(x, k):
        own.append(port_knn(x, k))
        return carried[len(own) - 1]

    monkeypatch.setattr(dgcnn, "knn", carried_knn)
    monkeypatch.setattr(paconv, "knn", carried_knn)
    state = task.create_state()
    state, mets = task.train_step(state, tensors(batch))
    assert torch.equal(own[0], carried[0])
    for mine, theirs in zip(own, carried):
        assert (mine != theirs).float().mean() < 0.01
    np.testing.assert_allclose(float(mets["loss"]), ref_loss,
                               rtol=limit("loss"))
    for key, p in model.named_parameters():
        if key == "linear2.bias":
            scale = float(ref_grads["linear2.kernel"].abs().max())
            assert float(p.grad.abs().max()) <= 1e-5 * scale, key
            assert float(ref_grads[key].abs().max()) <= 1e-5 * scale, key
            continue
        close_to_largest(p.grad.numpy(), ref_grads[key].numpy(),
                         limit("grad", key), key)
    for key, v in model.state_dict().items():
        close_to_largest(v.numpy(), ref_after[key].numpy(),
                         limit("after", key), key)


# -- checkpoints ---------------------------------------------------------------

def trace_of(model, optimizer):
    return convert.state_dict_to_flax(
        {n: optimizer.state[p]["momentum_buffer"]
         for n, p in model.named_parameters()},
        convert.flax_layout(model))["params"]


def check_states_both_ways(tmp_path, jmodel, model, variables, jtx, task,
                           batch, seed):
    """The port's state after one step through the reference's
    ``restore_into``, and a reference state with a random momentum trace
    through the port's, each bit for bit."""
    state = task.create_state()
    state, _ = task.train_step(state, batch)
    path = str(tmp_path / "port.ckpt")
    tck.save_training_state(path, state)
    bare = jstate_of(jmodel, variables, jtx)
    back = jck.restore_into(jax.tree_util.tree_map(jnp.zeros_like, bare),
                            jck.load_checkpoint(path), weights=True,
                            optimizer=True)
    want = convert.state_dict_to_flax(model.state_dict(),
                                      convert.flax_layout(model))
    for a, b in zip(jax.tree_util.tree_leaves(
            (want["params"], want["batch_stats"],
             trace_of(model, state.optimizer))),
            jax.tree_util.tree_leaves((back.params, back.batch_stats,
                                       back.opt_state[1][0].trace))):
        np.testing.assert_array_equal(np.asarray(b), a)
    rng = np.random.default_rng(seed)
    trace = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
        bare.params)
    inner = bare.opt_state[1]
    jstate = bare.replace(
        step=7, opt_state=(bare.opt_state[0],
                           (inner[0]._replace(trace=trace), *inner[1:])))
    jpath = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(jpath, jstate)
    ostate = task.create_state()
    raw = tck.load_checkpoint(jpath)
    tck.restore_into(ostate, raw, weights=True, optimizer=True)
    assert raw["global_step"] == 7
    got = convert.state_dict_to_flax(model.state_dict(),
                                     convert.flax_layout(model))
    for a, b in zip(jax.tree_util.tree_leaves(
            (got["params"], got["batch_stats"],
             trace_of(model, ostate.optimizer))),
            jax.tree_util.tree_leaves((jstate.params, jstate.batch_stats,
                                       trace))):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", [n for n in SMALL if n != "DGCNN_semseg"])
def test_training_states_both_ways(name, tmp_path):
    batch = field_batch() if name == "MinkowskiPointNet" else dense_batch()
    jmodel, model, variables = models(name, 4)
    for cfg in (jcfg, tcfg):
        cfg.parse_config("SGD.momentum = 0.9\n")
    kw = dict(scheduler_name="none", lr=0.1, weight_decay=1e-4)
    jtask, task = tasks(name, jmodel, model, **kw)
    check_states_both_ways(tmp_path, jmodel, model, variables,
                           jtask.make_tx(), task, tensors(batch), 4)


def test_paconv_pointnet_binding_takes_effect():
    for cfg in (jcfg, tcfg):
        cfg.parse_config("PAConvPointNet.k = 8\n")
    assert get_model("PAConvPointNet", in_channel=3, out_channel=40).k == 8
    # the reference accepts the binding and builds k = 20 all the same
    assert jget_model(name="PAConvPointNet", in_channel=3,
                      out_channel=40).k == 20
    tcfg.clear_config()
    tcfg.parse_config("get_model.k = 6\n")
    assert get_model("PAConvPointNet", in_channel=3, out_channel=40).k == 6


# -- the CLI -------------------------------------------------------------------

def applied_lr(before, after, trace) -> float:
    """The learning rate a momentum-SGD step applied: the least-squares
    ``lr`` of ``before - after = lr * trace`` over every leaf."""
    num = den = 0.0
    for p0, p1, t in zip(before, after, trace):
        t = np.asarray(t, np.float64)
        num += float(((np.asarray(p0, np.float64)
                       - np.asarray(p1, np.float64)) * t).sum())
        den += float((t * t).sum())
    return num / den


@contextlib.contextmanager
def recording(seen, lrs, opts):
    """Each CLI step's batch, in both packages, the port's applied
    learning rate (``applied_lr``), and the optimizers of the first step:
    the reference's ``tx`` and the port's (task, optimizer)."""
    keys = ("coordinates", "labels")
    make = jmod.BaseTask.make_train_step

    def recording_make(self, donate=True):
        fn = make(self, donate)

        def step(state, batch):
            seen["jax"].append({k: np.asarray(batch[k]) for k in keys})
            opts.setdefault("jax", state.tx)
            return fn(state, batch)
        return step

    step = tmod.BaseTask.train_step

    def recording_step(self, state, batch):
        seen["port"].append({k: batch[k].cpu().numpy() for k in keys})
        opts.setdefault("port", (self, state.optimizer))
        params = list(state.model.parameters())
        before = [p.detach().clone() for p in params]
        out = step(self, state, batch)
        lrs.append(applied_lr(
            before, [p.detach() for p in params],
            [state.optimizer.state[p]["momentum_buffer"] for p in params]))
        return out

    jmod.BaseTask.make_train_step = recording_make
    tmod.BaseTask.train_step = recording_step
    try:
        yield
    finally:
        jmod.BaseTask.make_train_step = make
        tmod.BaseTask.train_step = step


def check_same_momentum(opts, model, tree):
    """Two steps of the two CLIs' optimizers from ``tree``'s weights on the
    same gradients (0.5 everywhere, then 0.25): the reference's ``tx`` from
    its ``init``, and a fresh optimizer of the port's class and settings
    with each step's learning rate from the port's task. The momentum
    traces after them (0.9 x the first step's gradient and weight decay,
    plus the second's) agree within 1e-6 of each leaf's largest: the
    momentum and the weight decay as each CLI wired them."""
    tx = opts["jax"]
    task, optimizer = opts["port"]
    def two_steps(params):
        state = tx.init(params)
        for g in (0.5, 0.25):
            grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, g),
                                           params)
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
        return state

    state = jax.jit(two_steps)(jax.tree_util.tree_map(jnp.asarray,
                                                      tree["params"]))
    convert.load_flax_variables(model, tree)
    fresh = type(optimizer)(model.parameters(), **optimizer.defaults)
    for step, g in enumerate((0.5, 0.25)):
        for group in fresh.param_groups:
            group["lr"] = task.current_lr(step)
        for p in model.parameters():
            p.grad = torch.full_like(p, g)
        fresh.step()
    got = trace_of(model, fresh)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(state[1][0].trace)):
        close_to_largest(a, b, 1e-6, jax.tree_util.keystr(path))


def test_cli_matches_reference(tmp_path):
    from nerf_downstream_tpu.train.optim import get_scheduler
    from nerf_downstream_tpu_torch.data.synthetic import write_modelnet40_tree

    root = write_modelnet40_tree(str(tmp_path / "mn"),
                                 np.random.default_rng(0), n_train=8,
                                 n_test=4, n_points=N)
    model = get_model("PAConvDGCNN", in_channel=3, out_channel=40,
                      **SMALL["PAConvDGCNN"])
    start = str(tmp_path / "start.ckpt")
    tree = convert.init_flax_variables(model, 5)
    tck.save_checkpoint(start, tree["params"], tree["batch_stats"])
    # no dropout: the packages draw their masks from different generators
    # (the step test above carries the reference's masks instead)
    binds = ["get_model.k = 4", "get_model.num_matrices = (2, 2, 2, 2)",
             "get_model.dropout = 0.0",
             "ClassificationTraining.load_weights = True",
             f'ClassificationTraining.checkpoint_path = "{start}"']
    args = ["--model", "PAConvDGCNN", "--data_root", root,
            "--batch_size", "4", "--val_batch_size", "2", "--epochs", "1",
            "--num_points", str(N), "--seed", "3"]
    for b in binds:
        args += ["--ginb", b]
    seen = {"jax": [], "port": []}
    lrs, opts = [], {}
    with recording(seen, lrs, opts):
        want = jcli.main(args + ["--lr", "0",
                                 "--save_path", str(tmp_path / "jax")])
        # the reference's cosine over its CLI's steps (its CLI binds
        # train.max_steps to the epochs' steps), at lr 0.1
        schedule = get_scheduler("CosineAnnealingLR", 0.1)
        got = tcli.main(args + ["--lr", "0",
                                "--save_path", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for a, b in zip(seen["port"], seen["jax"]):
        for k in ("coordinates", "labels"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("val/acc1", "val/acc5", "val/loss"):
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    with open(tmp_path / "port" / "paconv" / "metrics.csv") as f:
        logged = [r for r in csv.DictReader(f) if r.get("val/acc1")]
    assert len(logged) == 1  # the best (here the last) checkpoint's pass
    check_same_momentum(opts, model, tree)

    # the learning rate the port's CLI applies at --lr 0.1: the reference's
    # cosine over the epochs' 2 steps, also on the third step that
    # --max_steps adds (lr 0 there: --max_steps ends the run and does not
    # stretch the cosine)
    lrs.clear()
    tcfg.clear_config()
    with recording({"jax": [], "port": []}, lrs, {}):
        tcli.main(args + ["--lr", "0.1", "--max_steps", "3",
                          "--save_path", str(tmp_path / "port_lr"),
                          "--device", "cpu"])
    np.testing.assert_allclose(
        lrs, [float(schedule(s)) for s in range(3)], rtol=1e-4, atol=1e-7)
    assert lrs[0] > lrs[1] > 0

    # a resume restores the weights and momentum buffers bit for bit
    last = str(tmp_path / "port" / "last.ckpt")
    saved = tck.load_checkpoint(last)
    restored = {}
    restore = tck.restore_into

    def recording_restore(state, raw, **kw):
        out = restore(state, raw, **kw)
        if kw.get("optimizer"):
            restored["params"] = convert.state_dict_to_flax(
                state.model.state_dict(),
                convert.flax_layout(state.model))["params"]
            restored["trace"] = trace_of(state.model, state.optimizer)
        return out

    tck.restore_into = recording_restore
    try:
        tcfg.clear_config()
        tcli.main(args + ["--lr", "0", "--save_path", str(tmp_path / "port"),
                          "--device", "cpu", "--max_steps", "3",
                          "--resume"])
    finally:
        tck.restore_into = restore
    assert tck.load_checkpoint(last)["global_step"] == 3
    trace = saved["opt_state"]["1"]["0"]["trace"]
    for a, b in zip(jax.tree_util.tree_leaves((saved["params"], trace)),
                    jax.tree_util.tree_leaves((restored["params"],
                                               restored["trace"]))):
        np.testing.assert_array_equal(b, a)
    assert os.path.exists(tmp_path / "port" / "best.ckpt")
