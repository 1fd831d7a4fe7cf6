"""The rest of the 3D model registry against the JAX package, on the CPU,
at small widths: the ResUNet2 family (row path), EncodedRes16UNet(2) on
both conv routes, and Res16UNet50/101. Every input is made from a seed
with numpy.

- Registry: every name the reference's ``_build`` builds, builds in the
  port, and each of its weights maps to one place in the reference's
  tree layout.
- ResUNet2 (channels 8-16): ResUNetBN2C and ResUNetIN2 (its top-level
  norms BatchNorm, its blocks' instance norms), with and without
  ``normalize_feature``: a train-mode step's outputs, every gradient of
  a fixed linear loss of the output and the updated BatchNorm statistics
  within 1e-5 of each leaf's largest entry; every conv on the row path.
- EncodedRes16UNet and EncodedRes16UNet2 (planes 8, one block per
  stage): the same on the row route and (slow) on the windowed route
  (the reference's XLA fallback, ``NDT_WINDOW_PALLAS=0``), in tier 1
  each model's windowed route against its row route in the port; and
  the trunk's
  gradient into ``enc_mlp`` per route, the reference's defect copied on
  purpose: exactly zero on the windowed route (``conv0a``'s
  ``input_grad=False``), nonzero on the row route.
- Res16UNet50 (planes 8, Bottleneck blocks, row path): eval logits and
  (slow) a train-mode step; Res16UNet101: eval logits.

The tests marked ``slow`` (the reference's windowed training step, whose
graph compiles for about a minute on one core with a cold cache;
Res16UNet50's step, two of the four ResUNet2 cases) run outside the
tier-1 command:
``pytest -m slow tests/test_torch_port_models_extra.py``.
- Training states of ResUNet2 and EncodedRes16UNet both ways bit for
  bit: the port's through the reference's ``restore_into``, the
  reference's through the port's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.models import get_model as jget_model  # noqa: E402
from nerf_downstream_tpu.models.mink import res16unet as jres16  # noqa: E402
from nerf_downstream_tpu.models.mink import resnet as jresnet  # noqa: E402
from nerf_downstream_tpu.sparse.types import PointField as JField  # noqa: E402
from nerf_downstream_tpu.train import checkpoints as jck  # noqa: E402
from nerf_downstream_tpu.train.optim import get_optimizer as jopt  # noqa: E402
from nerf_downstream_tpu.train.state import (  # noqa: E402
    TrainState as JTrainState,
)
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.models.mink.encoding import (  # noqa: E402
    positional_encode,
)
from nerf_downstream_tpu_torch.models.mink.layers import (  # noqa: E402
    SparseConv,
    SparseConvTranspose,
)
from nerf_downstream_tpu_torch.sparse.types import PointField  # noqa: E402
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from nerf_downstream_tpu_torch.train.optim import get_optimizer  # noqa: E402
from nerf_downstream_tpu_torch.train.state import TrainState  # noqa: E402

SCENES, CAP = 2, 1024
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
RESUNET = dict(channels=(8, 8, 16, 16), tr_channels=(8, 8, 8, 16))
ENCODED = dict(planes=(8,) * 8, layers=(1,) * 8, enc_planes=(8, 8),
               dec_planes=(8, 8))
# the windowed route's knobs (its k3/s1 and k2/s2 convs windowed)
WINDOWED = dict(
    method="hybrid", grid_extent=64,
    level_caps=(1024, 512, 256, 128, 64),
    window_tile=64, window_size=64, window_blocks=2,
    window_expand_factor=3,
    window_escape_cap=(2048, 512, 512, 128, 128),
    window_escape_tiles=(288, 144, 72, 36, 36),
)


def jax_names():
    """Every name the reference's ``_build`` builds."""
    return sorted({*jresnet._VARIANTS, *jres16.VARIANTS, "Res16UNet",
                   "EncodedRes16UNet", "EncodedRes16UNet2", "MinkowskiFCNN",
                   "MinkowskiSplatFCNN", "MinkowskiPointNet", "PointNet",
                   "DGCNN_cls", "DGCNN_semseg", "DGCNN", "ResUNet2",
                   "ResUNetBN2", "ResUNetBN2B", "ResUNetBN2C", "ResUNetBN2D",
                   "ResUNetBN2E", "ResUNetIN2", "ResUNetIN2B", "ResUNetIN2C",
                   "ResUNetIN2D", "ResUNetIN2E", "ResUNet14", "ResUNet18",
                   "ResUNet34", "PAConvPointNet", "PAConvDGCNN"})


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
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


# -- the registry --------------------------------------------------------------

@pytest.mark.parametrize("name", jax_names())
def test_every_reference_name_builds(name):
    """At full width, on the meta device (shapes only): every weight maps
    to one place in the reference's tree layout."""
    jget_model(name=name, in_channel=3, out_channel=20)  # the reference's
    with torch.device("meta"):
        model = get_model(name, in_channel=3, out_channel=20)
    keys = list(model.state_dict())
    path_of = convert._paths(convert.flax_layout(model))
    paths = [path_of(k) for k in keys]
    assert len(set(paths)) == len(paths) > 0
    assert {p[0] for p in paths} <= {"params", "batch_stats"}


# -- the sparse models ---------------------------------------------------------

def cloud_batch(seed=0, points=300):
    """SCENES shells of ``points`` points centred on the origin, one point
    per voxel (the reference's duplicate averaging has an f32 error of
    its own, ROADMAP Queue 3), coordinates in voxels, capacity CAP;
    features and a loss weight per row."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(SCENES):
        d = rng.normal(size=(points, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p = np.floor(d * 9.0 * rng.uniform(0.6, 1.0, 3)
                     + rng.normal(scale=0.3, size=(points, 3)))
        p = np.unique(p, axis=0)
        rows.append(np.concatenate([np.full((len(p), 1), b), p], 1))
    c = np.concatenate(rows).astype(np.float32)
    n = len(c)
    coords = np.zeros((CAP, 4), np.float32)
    coords[:n] = c
    mask = np.arange(CAP) < n
    feats = rng.normal(size=(CAP, 3)).astype(np.float32)
    return coords, feats, mask


def fields(coords, feats, mask):
    return (JField(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                   mask=jnp.asarray(mask)),
            PointField(coords=torch.as_tensor(coords),
                       feats=torch.as_tensor(feats),
                       mask=torch.as_tensor(mask)))


def bind(knobs):
    lines = ["field_to_sparse.assume_unique = True"]
    lines += [f"CoordinateContext.{k} = {v!r}" for k, v in knobs.items()]
    for cfg in (jcfg, tcfg):
        cfg.parse_config("\n".join(lines) + "\n")


def output_rows(out):
    return out.feats if hasattr(out, "feats") else out


def check_model(jmodel, model, variables, batch, seed=3, train=True):
    """Eval-mode outputs, or (``train``) a train-mode step's: its outputs,
    the gradients of ``sum(out * w)`` over the valid rows and the updated
    statistics, in both packages, each within 1e-5 of its largest entry
    (the reference compiles one of the two: its compiles are this file's
    time), or within twice
    the reference's own spread where that is larger: the most its own
    gradient moves when every input feature, or a seeded half of them,
    moves by one ulp up or down (deep stacks of train-mode norms, as
    Res16UNet50's, move by up to 5e-5 under such a change). A bias ahead of a train-mode BatchNorm (an
    EncodedRes16UNet's ``trunk.final.bias``, ahead of ``dec_mlp``'s) has
    a gradient that is zero in exact arithmetic and rounding in both
    packages: it is held below 1e-5 of its kernel's largest gradient
    instead."""
    coords, feats, mask = batch
    _, tf = fields(coords, feats, mask)
    convert.load_flax_variables(model, variables)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])

    def apply(p, f, train_mode):
        jf = JField(coords=jnp.asarray(coords), feats=f,
                    mask=jnp.asarray(mask))
        out = jmodel.apply({"params": p, "batch_stats": stats}, jf,
                           train=train_mode,
                           mutable=["batch_stats"] if train_mode else False)
        return out if train_mode else (out, {"batch_stats": stats})

    def run(p, w, f):
        if not train:
            return output_rows(apply(p, f, False)[0])

        def loss(q):
            out, mut = apply(q, f, True)
            rows = output_rows(out)
            return jnp.sum(jnp.where(jnp.asarray(mask)[:, None],
                                     rows * w, 0)), (rows, mut)

        (_, (rows, mut)), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return rows, grads, mut["batch_stats"]

    model.eval()
    with torch.no_grad():
        got = output_rows(model(tf))
    w = np.random.default_rng(seed).normal(
        size=(CAP, got.shape[1])).astype(np.float32)
    step = jax.jit(run).lower(params, w, feats).compile(
        compiler_options=FAST_XLA)
    ref = step(params, w, feats)
    m = mask
    if not train:
        close_to_largest(got.numpy()[m], np.asarray(ref)[m], 1e-5,
                         "eval output")
        return
    ref_rows, ref_grads, ref_stats = ref
    want_g = convert.flax_to_state_dict(model, jax.device_get(ref_grads))
    spread = {}

    def limit(key):
        """max(1e-5, twice the reference's spread), the spread measured
        (once) only when a leaf needs it."""
        if not spread:
            half = np.random.default_rng(seed + 1).random(feats.shape) < 0.5
            for toward, where in ((np.inf, True), (-np.inf, True),
                                  (np.inf, half), (-np.inf, half)):
                moved = np.where(where, np.nextafter(feats, toward), feats)
                alt = convert.flax_to_state_dict(model, jax.device_get(step(
                    params, w, moved.astype(np.float32))[1]))
                for k, v in alt.items():
                    spread[k] = max(spread.get(k, 0.0), float(
                        (v - want_g[k]).abs().max()
                        / want_g[k].abs().max().clamp(min=1e-30)))
        return max(1e-5, 2 * spread[key])
    model.train()
    rows = output_rows(model(tf))
    (rows * torch.as_tensor(w))[torch.as_tensor(m)].sum().backward()
    close_to_largest(rows.detach().numpy()[m], np.asarray(ref_rows)[m],
                     1e-5, "train output")
    for key, p in model.named_parameters():
        if not want_g[key].any():
            # no gradient at all (enc_mlp's on the windowed route of
            # EncodedRes16UNet2): none in the port either
            assert not p.grad.any(), key
            continue
        if key == "trunk.final.bias":
            scale = float(want_g["trunk.final.kernel"].abs().max())
            assert float(p.grad.abs().max()) <= 1e-5 * scale, key
            assert float(want_g[key].abs().max()) <= 1e-5 * scale, key
            continue
        g, want = p.grad.numpy(), want_g[key].numpy()
        gap = np.abs(g - want).max() / np.abs(want).max()
        close_to_largest(g, want, 1e-5 if gap <= 1e-5 else limit(key), key)
    want = convert.flax_to_state_dict(model, {
        "params": variables["params"],
        "batch_stats": jax.device_get(ref_stats)})
    for key, v in model.named_buffers():
        close_to_largest(v.numpy(), want[key].numpy(), 1e-5, key)


def routes(model):
    return {m.route for m in model.modules()
            if isinstance(m, (SparseConv, SparseConvTranspose))
            and m.route is not None}


@pytest.mark.parametrize("name,normalize", [
    ("ResUNetIN2", True),
    ("ResUNetBN2C", False),
    pytest.param("ResUNetIN2", False, marks=pytest.mark.slow),
    pytest.param("ResUNetBN2C", True, marks=pytest.mark.slow),
])
def test_resunet_matches_reference(name, normalize):
    bind({})
    kw = dict(RESUNET, normalize_feature=normalize, num_batches=SCENES)
    jmodel = jget_model(name=name, in_channel=3, out_channel=16, **kw)
    model = get_model(name, in_channel=3, out_channel=16, **kw)
    variables = convert.init_flax_variables(model, 1)
    check_model(jmodel, model, variables, cloud_batch())
    assert routes(model) == {"row"}
    out = model.eval()(fields(*cloud_batch())[1])
    if normalize:
        norms = torch.linalg.vector_norm(out.feats[out.mask], dim=1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def encoded_models(name, knobs):
    bind(knobs)
    kw = dict(ENCODED, num_batches=SCENES)
    jmodel = jget_model(name=name, in_channel=3, out_channel=20, **kw)
    model = get_model(name, in_channel=3, out_channel=20, ctx=knobs,
                      assume_unique=True, **kw)
    return jmodel, model, convert.init_flax_variables(model, 2)


def trunk_grad(model, batch):
    """The largest gradient the trunk alone sends into ``enc_mlp``."""
    model.train()
    model.zero_grad()
    _, tf = fields(*batch)
    enc = model.enc_mlp(positional_encode(tf.feats,
                                          model.num_encoding_functions),
                        tf.mask)
    out = model.trunk(PointField(coords=tf.coords, feats=enc, mask=tf.mask))
    w = torch.as_tensor(np.random.default_rng(4).normal(
        size=tuple(out.shape)).astype(np.float32))
    (out * w)[tf.mask].sum().backward()
    return max(float(p.grad.abs().max()) for p in model.enc_mlp.parameters())


def port_step(model, variables, batch, seed=3):
    """(eval logits, gradients of ``sum(logits * w)`` in train mode) of
    the port from ``variables``."""
    convert.load_flax_variables(model, variables)
    _, tf = fields(*batch)
    model.eval()
    with torch.no_grad():
        logits = model(tf)
    model.train()
    model.zero_grad()
    out = model(tf)
    w = np.random.default_rng(seed).normal(size=tuple(out.shape))
    (out * torch.as_tensor(w.astype(np.float32)))[tf.mask].sum().backward()
    return logits, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["EncodedRes16UNet", "EncodedRes16UNet2"])
def test_encoded_res16unet_matches_reference(name):
    """The row route against the reference's; the trunk's gradient into
    ``enc_mlp`` nonzero there. Then the windowed route against the row
    route in the port, from the same weights: the same logits and the
    same gradients but ``enc_mlp``'s, which the windowed route takes
    through the skip alone (EncodedRes16UNet2's, whose skip is the raw
    encoding, not at all): the reference's defect, copied: the trunk's
    gradient into ``enc_mlp`` is exactly zero there.
    ``test_encoded_windowed_route_matches_reference`` (slow) holds both
    models' windowed routes to the reference's own."""
    jmodel, model, variables = encoded_models(name, {})
    batch = cloud_batch(1)
    check_model(jmodel, model, variables, batch)
    assert routes(model) == {"row"}
    assert trunk_grad(model, batch) > 0.0
    row_logits, row_grads = port_step(model, variables, batch)
    # a context takes the gin bindings of each forward: the row model runs
    # no more once the windowed knobs are bound
    tcfg.clear_config()
    _, windowed, _ = encoded_models(name, WINDOWED)
    logits, grads = port_step(windowed, variables, batch)
    assert routes(windowed) == {"windowed"}
    m = batch[2]
    close_to_largest(logits.numpy()[m], row_logits.numpy()[m], 1e-5,
                     "logits")
    for key, g in grads.items():
        if key.startswith("enc_mlp.") or key == "trunk.final.bias":
            continue
        close_to_largest(g.numpy(), row_grads[key].numpy(), 1e-5, key)
    assert trunk_grad(windowed, batch) == 0.0


@pytest.mark.slow
@pytest.mark.parametrize("name", ["EncodedRes16UNet", "EncodedRes16UNet2"])
def test_encoded_windowed_route_matches_reference(name):
    """The windowed route against the reference's windowed route (its XLA
    fallback): slow, as the reference's windowed graph takes about a
    minute to compile on one core."""
    jmodel, model, variables = encoded_models(name, WINDOWED)
    batch = cloud_batch(1)
    check_model(jmodel, model, variables, batch)
    assert routes(model) == {"windowed"}
    assert trunk_grad(model, batch) == 0.0


@pytest.mark.parametrize("train", [
    False, pytest.param(True, marks=pytest.mark.slow)])
def test_res16unet50_matches_reference(train):
    bind({})
    kw = dict(planes=(8,) * 8, num_batches=SCENES)
    jmodel = jget_model(name="Res16UNet50", in_channel=3, out_channel=20,
                        **kw)
    model = get_model("Res16UNet50", in_channel=3, out_channel=20,
                      assume_unique=True, **kw)
    # the step's gradients: the port within 1.99x of the reference's own
    # spread at worst (block4.0, the first block at stride 16, whose
    # train-mode norms see a few dozen rows)
    check_model(jmodel, model, convert.init_flax_variables(model, 5),
                cloud_batch(2, points=200), train=train)
    assert routes(model) == {"row"}


def test_res16unet101_eval_matches_reference():
    bind({})
    kw = dict(planes=(8,) * 8, num_batches=SCENES)
    jmodel = jget_model(name="Res16UNet101", in_channel=3, out_channel=20,
                        **kw)
    model = get_model("Res16UNet101", in_channel=3, out_channel=20,
                      assume_unique=True, **kw)
    check_model(jmodel, model, convert.init_flax_variables(model, 6),
                cloud_batch(3, points=200), train=False)


# -- training states -----------------------------------------------------------

@pytest.mark.parametrize("name", ["ResUNetIN2C", "EncodedRes16UNet"])
def test_training_states_both_ways(name, tmp_path):
    kw = RESUNET if name.startswith("ResUNet") else ENCODED
    model = get_model(name, in_channel=3, out_channel=16, **kw)
    variables = convert.init_flax_variables(model, 7)
    convert.load_flax_variables(model, variables)
    for cfg in (jcfg, tcfg):
        cfg.parse_config("SGD.momentum = 0.9\n")
    rng = np.random.default_rng(8)
    opt = get_optimizer("SGD", model.parameters(), 0.1, 1e-4)
    for p in model.parameters():
        opt.state[p]["momentum_buffer"] = torch.as_tensor(
            rng.normal(size=tuple(p.shape)).astype(np.float32))
    state = TrainState(step=3, model=model, optimizer=opt)
    path = str(tmp_path / "port.ckpt")
    tck.save_training_state(path, state)
    layout = convert.flax_layout(model)
    tx = jopt("SGD", 0.1, 1e-4)
    bare = JTrainState.create(
        None, jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), tx)
    back = jck.restore_into(jax.tree_util.tree_map(jnp.zeros_like, bare),
                            jck.load_checkpoint(path), weights=True,
                            optimizer=True)
    want = convert.state_dict_to_flax(model.state_dict(), layout)
    trace = convert.state_dict_to_flax(
        {n: opt.state[p]["momentum_buffer"]
         for n, p in model.named_parameters()}, layout)["params"]
    for a, b in zip(jax.tree_util.tree_leaves((want["params"],
                                               want["batch_stats"], trace)),
                    jax.tree_util.tree_leaves((back.params, back.batch_stats,
                                               back.opt_state[1][0].trace))):
        np.testing.assert_array_equal(np.asarray(b), a)

    jtrace = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
        bare.params)
    inner = bare.opt_state[1]
    jstate = bare.replace(step=9, opt_state=(
        bare.opt_state[0], (inner[0]._replace(trace=jtrace), *inner[1:])))
    jpath = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(jpath, jstate)
    other = get_model(name, in_channel=3, out_channel=16, **kw)
    oopt = get_optimizer("SGD", other.parameters(), 0.1, 1e-4)
    ostate = TrainState(step=0, model=other, optimizer=oopt)
    raw = tck.load_checkpoint(jpath)
    tck.restore_into(ostate, raw, weights=True, optimizer=True)
    assert raw["global_step"] == 9
    got = convert.state_dict_to_flax(other.state_dict(), layout)
    bufs = convert.state_dict_to_flax(
        {n: oopt.state[p]["momentum_buffer"]
         for n, p in other.named_parameters()}, layout)["params"]
    for a, b in zip(jax.tree_util.tree_leaves((got["params"],
                                               got["batch_stats"], bufs)),
                    jax.tree_util.tree_leaves((jstate.params,
                                               jstate.batch_stats, jtrace))):
        np.testing.assert_array_equal(a, np.asarray(b))
