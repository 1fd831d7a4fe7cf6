"""The port's training slice against the JAX package, on the CPU.

- ``MaskedBatchNorm`` in train mode: output, gradient and the running
  statistics (unbiased variance) against the reference module, within
  1e-5 (f32 sums in another order).
- Device transforms: the blur, the trilinear gather, the feature jitter,
  the chromatic shift and the whole ElasticDistortion on the same numpy
  noise (the two
  packages' generators differ, so the reference's ``jax.random`` draws are
  replaced by that noise), within 1e-5.
- Every lr schedule, warmup included, against the reference's within
  1e-5 relative (the reference evaluates them in f32, the port in f64);
  SGD with momentum, weight decay and Nesterov against optax over 3 steps
  within 1e-6.
- One whole ``SegmentationTraining.train_step`` of a small Res16UNet14
  (planes of 8, f32, device transforms off, duplicate averaging on)
  against the reference's ``make_train_step(donate=False)``: the loss
  within 1e-5 relative; every parameter's gradient within 1e-4 x that
  parameter's largest gradient; the parameters after the SGD step within
  1e-5 and the running statistics within 1e-5 (rtol) and 1e-6 (atol);
  then a 3-step loss trajectory within 1e-4 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nerf_downstream_tpu import config as cfg  # noqa: E402
from nerf_downstream_tpu.data import device_transforms as JDT  # noqa: E402
from nerf_downstream_tpu.models import get_model as jax_get_model  # noqa: E402
from nerf_downstream_tpu.models.mink.layers import (  # noqa: E402
    MaskedBatchNorm as JBN,
)
from nerf_downstream_tpu.sparse.types import SparseVoxels as JSV  # noqa: E402
from nerf_downstream_tpu.train import optim as JO  # noqa: E402
from nerf_downstream_tpu.train.modules import (  # noqa: E402
    SegmentationTraining as JTask,
)
from nerf_downstream_tpu.train.state import (  # noqa: E402
    TrainState as JTrainState,
)
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.data import device_transforms as TDT  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.models.mink.layers import (  # noqa: E402
    MaskedBatchNorm,
)
from nerf_downstream_tpu_torch.sparse.types import SparseVoxels  # noqa: E402
from nerf_downstream_tpu_torch.train import optim as TO  # noqa: E402
from nerf_downstream_tpu_torch.train.modules import (  # noqa: E402
    SegmentationTraining,
)
from tests.test_torch_port_model import (  # noqa: E402
    CLASSES,
    KNOBS,
    make_batch,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _setup():
    cfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    cfg.clear_config()


def test_batch_norm_train_mode_matches_reference(rng):
    n, c = 300, 7
    feats = (rng.normal(size=(n, c)) * 3 + 1).astype(np.float32)
    mask = rng.random(n) < 0.7
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    ra_mean = rng.normal(size=c).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    coords = np.zeros((n, 4), np.int32)

    def ref_fn(f, s, b):
        sv = JSV(coords=jnp.asarray(coords), feats=f, mask=jnp.asarray(mask))
        out, mut = JBN(momentum=0.1).apply(
            {"params": {"scale": s, "bias": b},
             "batch_stats": {"mean": jnp.asarray(ra_mean),
                             "var": jnp.asarray(ra_var)}},
            sv, True, mutable=["batch_stats"])
        return jnp.sum(out.feats * g), (out.feats, mut["batch_stats"])

    (_, (ref_out, ref_stats)), ref_grads = jax.value_and_grad(
        ref_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(scale), jnp.asarray(bias))

    bn = MaskedBatchNorm(c, momentum=0.1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(scale))
        bn.bias.copy_(torch.as_tensor(bias))
        bn.running_mean.copy_(torch.as_tensor(ra_mean))
        bn.running_var.copy_(torch.as_tensor(ra_var))
    f = torch.as_tensor(feats).requires_grad_()
    out = bn(SparseVoxels(coords=torch.as_tensor(coords), feats=f,
                          mask=torch.as_tensor(mask))).feats
    (out * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    for got, ref in zip((f.grad, bn.weight.grad, bn.bias.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(ref_stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(ref_stats["var"]), rtol=1e-5,
                               atol=1e-6)
    # eval mode reads the running statistics and leaves them as they are
    before = bn.running_var.clone()
    bn.eval()(SparseVoxels(coords=torch.as_tensor(coords), feats=f.detach(),
                           mask=torch.as_tensor(mask)))
    assert torch.equal(bn.running_var, before)


def _scenes(rng, s=3, n=240):
    """A small batch of s scenes (coords with the scene id in column 0)
    and a padding tail."""
    coords = np.zeros((n, 4), np.float32)
    coords[:, 0] = rng.integers(0, s, n)
    coords[:, 1:] = rng.uniform(0, 20, (n, 3)).astype(np.float32)
    coords[:, 1] += coords[:, 0] * 5  # scenes of different extents
    mask = np.arange(n) < n - 20
    feats = rng.normal(size=(n, 27)).astype(np.float32)
    return coords, feats, mask


def test_blur_and_trilinear_match_reference(rng):
    noise = rng.normal(size=(3, 9, 9, 9, 3)).astype(np.float32)
    dims = np.array([[9, 9, 9], [5, 7, 3], [2, 9, 6]], np.int32)
    ref = jax.jit(JDT._masked_box_blur)(jnp.asarray(noise),
                                        jnp.asarray(dims))
    got = TDT.masked_box_blur(torch.as_tensor(noise), torch.as_tensor(dims))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    sidx = rng.integers(0, 3, 400)
    gpos = rng.uniform(0, 8, (400, 3)).astype(np.float32)
    gpos[:5] = 8.0  # the upper boundary takes the last cell
    ref = jax.jit(JDT._trilinear_scenes)(ref, jnp.asarray(sidx),
                                         jnp.asarray(gpos))
    got = TDT.trilinear_scenes(got, torch.as_tensor(sidx),
                               torch.as_tensor(gpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _feed(monkeypatch, uniforms, normals):
    """Replace the reference's jax.random draws by the given numpy arrays,
    in call order."""
    u, nm = list(uniforms), list(normals)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(u.pop(0)))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(nm.pop(0)))


def _jax_batch(coords, feats, mask):
    return {"coordinates": jnp.asarray(coords), "features": jnp.asarray(feats),
            "mask": jnp.asarray(mask)}


def _torch_batch(coords, feats, mask):
    return {"coordinates": torch.as_tensor(coords),
            "features": torch.as_tensor(feats), "mask": torch.as_tensor(mask)}


def test_feature_jitter_matches_reference(rng, monkeypatch):
    coords, feats, mask = _scenes(rng)
    t = TDT.RandomFeatureJitter(std=0.5, application_ratio=0.5)
    gen = torch.Generator().manual_seed(0)
    draws = t.draw(_torch_batch(coords, feats, mask), gen)
    assert draws["noise"].shape == (len(coords), 23)  # slice clamped
    got = t.apply(_torch_batch(coords, feats, mask), draws)["features"]
    _feed(monkeypatch, [draws["gate"].numpy()], [draws["noise"].numpy()])
    ref = jax.jit(JDT._feature_jitter(t))(
        _jax_batch(coords, feats, mask), jax.random.PRNGKey(0))["features"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    changed = (got.numpy() != feats).any(1)
    assert changed.any() and not changed[~mask].any()


def test_chromatic_translation_matches_reference(rng, monkeypatch):
    coords, feats, mask = _scenes(rng)
    feats[:, :3] = rng.uniform(0, 255, (len(feats), 3))
    t = TDT.ChromaticTranslation(trans_range_ratio=0.3, application_ratio=0.5)
    draws = t.draw(_torch_batch(coords, feats, mask),
                   torch.Generator().manual_seed(2))
    got = t.apply(_torch_batch(coords, feats, mask), draws)["features"]
    _feed(monkeypatch, [draws["gate"].numpy(), draws["shift"].numpy()], [])
    ref = jax.jit(JDT._chromatic_translation(t))(
        _jax_batch(coords, feats, mask), jax.random.PRNGKey(0))["features"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    changed = (got.numpy() != feats).any(1)
    assert changed.any() and not changed[~mask].any()
    assert got[:, :3].min() >= 0 and got[:, :3].max() <= 255


def test_elastic_distortion_matches_reference(rng, monkeypatch):
    coords, feats, mask = _scenes(rng)
    t = TDT.ElasticDistortion(distortion_params=((4, 16), (8, 24)),
                              application_ratio=0.6, max_extent=40,
                              num_scenes=3)
    gen = torch.Generator().manual_seed(1)
    tb = _torch_batch(coords, feats, mask)
    draws = t.draw(tb, gen)
    draws["gate"] = torch.tensor([0.1, 0.9, 0.3])  # scene 1 stays put
    got = t.apply(tb, draws)["coordinates"].numpy()
    _feed(monkeypatch, [draws["gate"].numpy()],
          [n.numpy() for n in draws["noise"]])
    ref = jax.jit(JDT._elastic_distortion(t, num_scenes=3))(
        _jax_batch(coords, feats, mask), jax.random.PRNGKey(0))
    np.testing.assert_allclose(got, np.asarray(ref["coordinates"]), **TOL)
    moved = np.abs(got - coords).max(1) > 0
    assert moved[mask & (coords[:, 0] != 1)].all()
    assert not moved[(coords[:, 0] == 1) | ~mask].any()
    # a gated scene wider than the static grid poisons every coordinate
    small = TDT.ElasticDistortion(((4, 16),), 1.0, max_extent=8,
                                  num_scenes=3)
    out = small(tb, gen)["coordinates"]
    assert torch.isnan(out[:, 1:]).all()


SCHEDULES = [
    ("StepLR", dict(step_size=7, gamma=0.5), {}),
    ("MultiStepLR", dict(milestones=(5, 12), gamma=0.3), {}),
    ("ExponentialLR", dict(gamma=0.9), {}),
    ("CosineAnnealingLR", dict(eta_min=0.01), dict(max_steps=30)),
    ("CyclicLR", dict(base_lr=1e-3, step_size_up=4, mode="triangular2"), {}),
    ("CyclicLR", dict(base_lr=1e-3, step_size_up=4, mode="exp_range",
                      gamma=0.9), {}),
    ("CyclicLR", dict(base_lr=1e-3, step_size_up=4, mode="cosine"),
     dict(max_steps=30)),
    ("PolyLR", dict(poly_exp=0.9), dict(max_steps=30)),
    ("SquaredLR", dict(max_iter=30), {}),
]


@pytest.mark.parametrize("warmup", [None, 5])
def test_schedules_match_reference(warmup):
    cfg.parse_config("train.max_steps = 30\ntrain.lr = 0.2\n"
                     "train.scheduler_interval = 'step'")
    for name, kw, from_config in SCHEDULES:
        ref = JO.SCHEDULERS[name](0.2, **kw)
        got = TO.get_scheduler(name, 0.2, warmup, **kw, **from_config)
        if warmup:
            ref = JO.warmup_wrap(ref, 0.2, warmup)
        for step in range(0, 31):
            np.testing.assert_allclose(got(step), float(ref(step)),
                                       rtol=1e-5, atol=1e-9,
                                       err_msg=f"{name} {kw} step {step}")
    assert TO.get_scheduler("none", 0.2) is None


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_optax(rng, nesterov):
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    tx = JO.sgd(0.05, weight_decay=1e-2, momentum=0.9, nesterov=nesterov)
    p_ref = jnp.asarray(p0)
    state = tx.init(p_ref)
    p = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = TO.sgd([p], 0.05, weight_decay=1e-2, momentum=0.9,
                 nesterov=nesterov)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        p.grad = torch.as_tensor(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_ref),
                                   rtol=1e-6, atol=1e-6)


def _bindings() -> str:
    lines = ['CoordinateContext.method = "hybrid"',
             "field_to_sparse.assume_unique = False"]
    lines += [f"CoordinateContext.{k} = {v!r}" for k, v in KNOBS.items()]
    return "\n".join(lines) + "\n"


def test_train_step_matches_reference(monkeypatch):
    """One SGD step (lr 0.1, weight decay 1e-5, no schedule) of the whole
    segmentation task, then two more steps' losses."""
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    cfg.parse_config(_bindings())
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if k in ("coordinates", "features", "mask", "labels")}
    jmodel = jax_get_model(name="Res16UNet14", out_channel=CLASSES,
                           num_batches=2, planes=(8,) * 8)
    jtask = JTask(jmodel, scheduler_name="none", lr=0.1, ignore_label=-100)
    model = get_model("Res16UNet14", in_channel=27, out_channel=CLASSES,
                      planes=(8,) * 8, ctx=KNOBS, assume_unique=False)
    # random weights and BatchNorm statistics in the reference's layout
    variables = convert.init_flax_variables(model, seed=1)
    convert.load_flax_variables(model, variables)
    # the reference's optimizer behind a pass-through stage that keeps the
    # step's gradients in the optimizer state (one compiled step gives
    # both the gradients and the update)
    def stash_grads():
        return optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))

    jstate = JTrainState.create(
        jmodel.apply,
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        optax.chain(stash_grads(), jtask.make_tx()))
    # XLA's CPU backend at its lowest optimization level: the same
    # arithmetic, compiled in about half the time
    step = jtask.make_train_step(donate=False).lower(jstate, jbatch).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    ref_losses = []
    ref_state = jstate
    for i in range(3):
        ref_state, mets = step(ref_state, jbatch)
        ref_losses.append(float(mets["loss"]))
        if i == 0:
            ref_grads = ref_state.opt_state[0]
            ref_after = {"params": jax.device_get(ref_state.params),
                         "batch_stats": jax.device_get(
                             ref_state.batch_stats)}

    task = SegmentationTraining(model, scheduler_name="none", lr=0.1,
                                ignore_label=-100)
    state = task.create_state()
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()
              if k in ("coordinates", "features", "mask")}
    tbatch["labels"] = torch.as_tensor(batch["labels"]).long()
    losses = []
    for i in range(3):
        state, mets = task.train_step(state, tbatch)
        losses.append(float(mets["loss"]))
        if i == 0:
            grads = {k: p.grad for k, p in model.named_parameters()}
            after = {k: v.clone() for k, v in model.state_dict().items()}

    assert np.isfinite(losses).all() and len(set(losses)) == 3
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-5)
    want = convert.flax_to_state_dict(model, jax.device_get(ref_grads))
    assert set(want) == set(grads)
    for key, g in grads.items():
        scale = float(want[key].abs().max())
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=key)
    ref_sd = convert.flax_to_state_dict(model, ref_after)
    for key, v in after.items():
        np.testing.assert_allclose(v.numpy(), ref_sd[key].numpy(),
                                   rtol=1e-5, atol=1e-5 if "running" not in
                                   key else 1e-6, err_msg=key)
    # the reference's layout round-trips the updated state
    back = convert.state_dict_to_flax(after)
    np.testing.assert_array_equal(
        back["batch_stats"]["MaskedBatchNorm_0"]["var"],
        after["conv0a.norm.running_var"].numpy())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
