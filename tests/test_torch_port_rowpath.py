"""The port's row path for every conv against the JAX package's, on the
CPU, on clouds centred on the origin (negative coordinates on half of
every axis).

- The route each conv takes: windowed or row by the context's method;
  a k3/s1 conv under "block", "block_resident" and "window" against the
  row path.
- Exact equality: the strided levels (2, 4, 8) and ``slice_field`` at
  each; the kernel maps of k3/s1, k3/s2, dilation-2 k3/s1 and the
  transpose map (fresh, and inverted from the forward map in the cache),
  by sort and search and through the grid index.
- Within 1e-5 of the largest value: ``splat`` and ``interpolate`` and
  their gradients; the row convs (k3/s1, k3/s2, dilated, k2/s2, the k2
  transpose conv) and the k3/s2 max pooling, forward and gradients.
- Res16UNet14 at planes 8 on the row path ("auto" without a grid
  extent): eval logits within 1e-5 x max|logit| and one SGD step (loss,
  gradients and weights within 1e-5 of each leaf's largest); a dilated
  variant's logits on the windowed path, its dilated convs on the row
  path with grid maps.

The reference runs its XLA fallback (``NDT_WINDOW_PALLAS=0``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.models import get_model as jget_model  # noqa: E402
from nerf_downstream_tpu.models.mink.layers import (  # noqa: E402
    SparseConv as JConv,
    SparseConvTranspose as JConvT,
    SparsePool as JPool,
)
from nerf_downstream_tpu.ops import interpolate as JI  # noqa: E402
from nerf_downstream_tpu.sparse import context as jctx  # noqa: E402
from nerf_downstream_tpu.sparse import kernels as jk  # noqa: E402
from nerf_downstream_tpu.sparse.types import PointField as JField  # noqa: E402
from nerf_downstream_tpu.sparse.types import SparseVoxels as JVoxels  # noqa: E402
from nerf_downstream_tpu.train.modules import (  # noqa: E402
    SegmentationTraining as JTask,
)
from nerf_downstream_tpu.train.state import (  # noqa: E402
    TrainState as JTrainState,
)
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.models.mink.layers import (  # noqa: E402
    SparseConv,
    SparseConvTranspose,
    SparsePool,
)
from nerf_downstream_tpu_torch.ops import interpolate as TI  # noqa: E402
from nerf_downstream_tpu_torch.sparse import context as tctx  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as tk  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import PointField  # noqa: E402
from nerf_downstream_tpu_torch.train.modules import (  # noqa: E402
    SegmentationTraining,
)

SCENES, CAP = 3, 2048
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
# the windowed knobs of the dilated variant (its plain convs windowed, its
# dilated ones on the row path through the grid index)
WINDOWED = dict(
    method="hybrid", grid_extent=64,
    level_caps=(2048, 1024, 512, 256, 128),
    window_tile=64, window_size=64, window_blocks=2,
    window_expand_factor=3,
    window_escape_cap=(4096, 1024, 1024, 256, 256),
    window_escape_tiles=(288, 144, 72, 36, 36),
)


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


def cloud_batch(seed=0, points=500, radius=14.0):
    """A batch of SCENES shells of ``points`` points centred on the
    origin (coordinates in voxels, continuous), capacity CAP."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((CAP, 4), np.float32)
    for b in range(SCENES):
        d = rng.normal(size=(points, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p = d * radius * rng.uniform(0.6, 1.0, 3) + rng.normal(
            scale=0.3, size=(points, 3))
        coords[b * points:(b + 1) * points, 0] = b
        coords[b * points:(b + 1) * points, 1:] = p
    mask = np.arange(CAP) < SCENES * points
    assert (coords[mask, 1:] < 0).any(0).all()
    return coords, mask


def fields(coords, mask, channels, seed=1):
    feats = np.random.default_rng(seed).normal(
        size=(coords.shape[0], channels)).astype(np.float32)
    jf = JField(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                mask=jnp.asarray(mask))
    tf = PointField(coords=torch.as_tensor(coords),
                    feats=torch.as_tensor(feats), mask=torch.as_tensor(mask))
    return jf, tf


def close_to_largest(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def pyramid(coords, mask):
    """The voxel levels at strides 1, 2, 4 and 8 in both packages."""
    jf, tf = fields(coords, mask, 4)
    jsv, _ = jk.field_to_sparse(jf)
    tsv, _ = tk.field_to_sparse(tf)
    jl, tl = [jsv], [tsv]
    for _ in range(3):
        jl.append(jk.stride_coords(jl[-1], 2))
        tl.append(tk.stride_coords_capped(tl[-1], 2, None)[0])
    return jf, tf, jl, tl


# -- routes ------------------------------------------------------------------

@pytest.mark.parametrize("knobs,routes", [
    ({}, ("row", "row", "row", "row")),
    ({"method": "row", "grid_extent": 64}, ("row",) * 4),
    ({"method": "search"}, ("row",) * 4),
    ({"grid_extent": 64}, ("windowed", "row", "row", "windowed")),
    ({"method": "hybrid"}, ("windowed", "row", "row", "windowed")),
])
def test_each_conv_takes_the_reference_route(knobs, routes):
    """k3/s1, k3/s2, dilated k3/s1, k2/s2: the route each takes."""
    ctx = tctx.CoordinateContext(num_batches=SCENES, **knobs)
    got = tuple(ctx.conv_route(ok) for ok in (True, False, False, True))
    assert got == routes
    assert ctx._use_grid() == (knobs.get("method") != "search"
                               and "grid_extent" in knobs)


@pytest.mark.parametrize("method", ["block", "block_resident", "window"])
def test_unported_methods_raise(method):
    """The methods that used to raise run now: a k3/s1 conv under each
    gives the row path's rows within 1e-5 of the largest (the method's
    own tests are test_torch_port_methods*.py and
    test_torch_port_block.py)."""
    coords, mask = cloud_batch()
    _, tf = fields(coords, mask, 4)
    sv, _ = tk.field_to_sparse(tf)
    conv = SparseConv(4, 4, 3, 1)
    with torch.no_grad():
        conv.kernel.copy_(torch.as_tensor(np.random.default_rng(3).normal(
            size=(27, 4, 4)).astype(np.float32)))
        row = conv(sv, tctx.CoordinateContext(num_batches=SCENES,
                                              method="row"))
        out = conv(sv, tctx.CoordinateContext(
            num_batches=SCENES, method=method, grid_extent=64,
            block_cap_divisor=1))
    assert conv.route == method
    m = sv.mask.numpy()
    close_to_largest(layers_rows(out)[m], row.feats.numpy()[m], 1e-5,
                     method)


def layers_rows(out):
    from nerf_downstream_tpu_torch.models.mink.layers import as_rows

    return as_rows(out).feats.numpy()


# -- levels, slicing, kernel maps --------------------------------------------

def test_strided_levels_and_slice_field_match_reference():
    coords, mask = cloud_batch()
    jf, tf, jl, tl = pyramid(coords, mask)
    for j, t in zip(jl, tl):
        np.testing.assert_array_equal(t.coords.numpy(), np.asarray(j.coords))
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
        assert t.stride == j.stride
        assert (t.coords.numpy()[t.mask.numpy(), 1:] < 0).any()
        feats = np.random.default_rng(t.stride).normal(
            size=(t.capacity, 5)).astype(np.float32)
        ref = jk.slice_field(j.replace(feats=jnp.asarray(feats)), jf)
        got = tk.slice_field(t.replace(feats=torch.as_tensor(feats)), tf)
        np.testing.assert_array_equal(got.feats.numpy(), np.asarray(ref.feats))
        # every valid point finds its voxel at every stride
        hit = np.abs(got.feats.numpy()[mask]).sum(1) > 0
        assert hit.all()


@pytest.mark.parametrize("grid", [False, True])
def test_row_kernel_maps_match_reference(grid):
    coords, mask = cloud_batch()
    _, _, jl, tl = pyramid(coords, mask)
    knobs = {"grid_extent": 64, "method": "row"} if grid else {}
    jc = jctx.CoordinateContext(num_batches=SCENES, **knobs)
    tc = tctx.CoordinateContext(num_batches=SCENES, **knobs)
    cases = [  # (in level, out level, offsets, transpose)
        (1, 1, tk.kernel_offsets(3, 2), False),          # k3/s1
        (1, 2, tk.kernel_offsets(3, 2), False),          # k3/s2
        (1, 1, tk.kernel_offsets(3, 2, 2), False),       # dilation 2
        (2, 1, tk.kernel_offsets(3, 2), True),           # transpose, fresh
        (0, 1, tk.kernel_offsets(2, 1), False),          # k2/s2
        (1, 0, tk.kernel_offsets(2, 1), True),           # its inversion
    ]
    for i, o, offs, tr in cases:
        args = lambda lv: (lv[i].coords, lv[i].mask, lv[o].coords,  # noqa: E731
                           lv[o].mask, offs)
        ref = jc.kernel_map(*args(jl), transpose=tr, in_stride=jl[i].stride)
        got = tc.kernel_map(*args(tl), transpose=tr, in_stride=tl[i].stride)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        n_in = tl[i].capacity
        assert (got.numpy() < n_in).any() and (got.numpy() == n_in).any()


# -- splat and interpolate ---------------------------------------------------

def test_splat_and_interpolate_match_reference():
    coords, mask = cloud_batch(points=300)
    jf, tf = fields(coords, mask, 6)
    corners = np.floor(coords[:, 1:]).astype(np.int32)
    vc = np.concatenate([coords[:, :1].astype(np.int32), corners], 1)
    uc, um, _ = jk.unique_coords(jnp.asarray(vc), jnp.asarray(mask))
    tuc, tum = torch.as_tensor(np.array(uc)), torch.as_tensor(np.array(um))

    def jsplat(feats):
        return JI.splat(jf.replace(feats=feats), uc, um, 1)

    ref, ref_vjp = jax.vjp(jsplat, jf.feats)
    feats = tf.feats.clone().requires_grad_(True)
    got = TI.splat(PointField(tf.coords, feats, tf.mask), tuc, tum, 1)
    close_to_largest(got.detach().numpy(), ref, 1e-5, "splat")
    g = np.random.default_rng(3).normal(size=ref.shape).astype(np.float32)
    (got * torch.as_tensor(g)).sum().backward()
    close_to_largest(feats.grad.numpy(), ref_vjp(jnp.asarray(g))[0], 1e-5,
                     "splat grad")

    for stride in (1, 2, 4):
        lv = jk.stride_coords(JVoxels(
            coords=uc, feats=jnp.zeros((CAP, 0)), mask=um, stride=1),
            stride) if stride > 1 else None
        cs, ms = (uc, um) if lv is None else (lv.coords, lv.mask)
        vf = np.random.default_rng(stride).normal(size=(CAP, 5)).astype(
            np.float32)

        def jint(v):
            return JI.interpolate(cs, ms, v, stride, jf)

        ref, ref_vjp = jax.vjp(jint, jnp.asarray(vf))
        v = torch.as_tensor(vf).requires_grad_(True)
        got = TI.interpolate(torch.as_tensor(np.array(cs)),
                             torch.as_tensor(np.array(ms)), v, stride, tf)
        close_to_largest(got.detach().numpy(), ref, 1e-5, f"interp {stride}")
        g = np.random.default_rng(5).normal(size=ref.shape).astype(np.float32)
        (got * torch.as_tensor(g)).sum().backward()
        close_to_largest(v.grad.numpy(), ref_vjp(jnp.asarray(g))[0], 1e-5,
                         f"interp grad {stride}")


# -- row convs and the max pooling -------------------------------------------

CONVS = {"k3s1": (3, 1, 1), "k3s2": (3, 2, 1), "dil2": (3, 1, 2),
         "k2s2": (2, 2, 1)}


class _JLayer(fnn.Module):
    kind: str

    @fnn.compact
    def __call__(self, field):
        ctx = jctx.CoordinateContext(num_batches=SCENES)
        sv, _ = jk.field_to_sparse(field)
        if self.kind == "pool":
            out = JPool(3, 2, "max", name="pool")(sv, ctx)
        elif self.kind == "transpose":
            down = JConv(8, 2, 2, name="down")(sv, ctx)
            out = JConvT(8, 2, 2, name="up")(down, ctx, sv)
        else:
            k, s, d = CONVS[self.kind]
            out = JConv(8, k, s, d, use_bias=True, name="conv")(sv, ctx)
        return out.masked_feats(), out.coords, out.mask


def port_layer(kind, params):
    """(the port's layer as a function of a level, its weights by the
    reference's module name), with the reference's weights."""
    if kind == "pool":
        pool = SparsePool(3, 2, "max")
        return (lambda sv, ctx: pool(sv, ctx)), {}, ()
    if kind == "transpose":
        down, up = SparseConv(6, 8, 2, 2), SparseConvTranspose(8, 8)
        mods = {"down": down, "up": up}
        fn = lambda sv, ctx: up(down(sv, ctx), ctx, sv)  # noqa: E731
    else:
        k, s, d = CONVS[kind]
        conv = SparseConv(6, 8, k, s, use_bias=True, dilation=d)
        mods = {"conv": conv}
        fn = conv
    with torch.no_grad():
        for name, m in mods.items():
            for leaf, t in params[name].items():
                getattr(m, leaf).copy_(torch.as_tensor(np.array(t)))
    return fn, {n: m.kernel for n, m in mods.items()}, tuple(mods.values())


@pytest.mark.parametrize("kind", ["k3s1", "k3s2", "dil2", "k2s2",
                                  "transpose", "pool"])
def test_row_layers_match_reference(kind):
    coords, mask = cloud_batch(points=300)
    jf, tf = fields(coords, mask, 6)
    layer = _JLayer(kind)
    params = dict(jax.jit(layer.init)(jax.random.PRNGKey(0), jf).get(
        "params", {}))
    if "conv" in params:  # a bias that is not zero
        params["conv"] = dict(params["conv"], bias=jnp.linspace(-.5, .5, 8))
    shape = jax.eval_shape(layer.apply, {"params": params}, jf)[0].shape
    r = np.random.default_rng(4).normal(size=shape).astype(np.float32)

    def fwd_bwd(params, feats):
        def loss(params, feats):
            out = layer.apply({"params": params}, jf.replace(feats=feats))
            return jnp.sum(out[0] * r), out
        return jax.grad(loss, argnums=(0, 1), has_aux=True)(params, feats)

    (g_params, g_feats), (ref_f, ref_c, ref_m) = jax.jit(fwd_bwd).lower(
        params, jf.feats).compile(compiler_options=FAST_XLA)(params,
                                                             jf.feats)
    fn, weights, mods = port_layer(kind, params)
    ctx = tctx.CoordinateContext(num_batches=SCENES)
    feats = tf.feats.clone().requires_grad_(True)
    sv, _ = tk.field_to_sparse(PointField(tf.coords, feats, tf.mask))
    out = fn(sv, ctx)
    assert {m.route for m in mods} <= {"row"}
    np.testing.assert_array_equal(out.coords.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref_m))
    got = out.masked_feats()
    close_to_largest(got.detach().numpy(), ref_f, 1e-5, "forward")
    (got * torch.as_tensor(r)).sum().backward()
    close_to_largest(feats.grad.numpy(), g_feats, 1e-5, "d_feats")
    for name, w in weights.items():
        close_to_largest(w.grad.numpy(), g_params[name]["kernel"], 1e-5,
                         f"d_w {name}")


# -- Res16UNet14 on the row path ---------------------------------------------

def unet_batch():
    coords, mask = cloud_batch(points=400)
    # one point per voxel: the reference's duplicate averaging carries an
    # f32 error of its own (ROADMAP Queue 3), so the batch has no
    # duplicates
    c = np.floor(coords)
    _, first = np.unique(c[mask], axis=0, return_index=True)
    keep = np.zeros(CAP, bool)
    keep[np.flatnonzero(mask)[first]] = True
    n = keep.sum()
    out = np.zeros_like(coords)
    out[:n] = c[keep]
    labels = np.full(CAP, -100, np.int32)
    labels[:n] = np.random.default_rng(7).integers(0, 20, n)
    feats = np.random.default_rng(8).normal(size=(CAP, 3)).astype(np.float32)
    return {"coordinates": out, "features": feats,
            "mask": np.arange(CAP) < n, "labels": labels}


def unets(dilations=(1,) * 8, knobs=None):
    lines = ["field_to_sparse.assume_unique = True"]
    lines += [f"CoordinateContext.{k} = {v!r}"
              for k, v in (knobs or {}).items()]
    jcfg.parse_config("\n".join(lines) + "\n")
    jmodel = jget_model(name="Res16UNet14", in_channel=3, out_channel=20,
                        num_batches=SCENES, planes=(8,) * 8,
                        dilations=dilations)
    model = get_model("Res16UNet14", in_channel=3, out_channel=20,
                      planes=(8,) * 8, num_batches=SCENES, ctx=knobs,
                      assume_unique=True, dilations=dilations)
    variables = convert.init_flax_variables(model, 3)
    convert.load_flax_variables(model, variables)
    return jmodel, model, variables


def jstate_of(jmodel, jtask, variables, tx=None):
    return JTrainState.create(
        jmodel.apply,
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        tx or jtask.make_tx())


def check_unet_eval(dilations=(1,) * 8, knobs=None):
    batch = unet_batch()
    jmodel, model, variables = unets(dilations, knobs)
    jtask = JTask(jmodel, scheduler_name="none")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jstate_of(jmodel, jtask, variables)
    ref, _ = jtask.make_eval_step().lower(state, jb).compile(
        compiler_options=FAST_XLA)(state, jb)
    task = SegmentationTraining(model, scheduler_name="none")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    logits, _ = task.eval_step(task.create_state(), tb)
    m = batch["mask"]
    close_to_largest(logits.numpy()[m], np.asarray(ref)[m], 1e-5, "logits")
    return model


def test_res16unet14_row_path_eval_matches_reference():
    model = check_unet_eval()
    convs = [m for m in model.modules()
             if isinstance(m, (SparseConv, SparseConvTranspose))
             and m.route is not None]
    assert len(convs) > 20 and {m.route for m in convs} == {"row"}


def test_res16unet14_dilated_eval_matches_reference():
    model = check_unet_eval((1, 2, 1, 2, 1, 1, 2, 1), WINDOWED)
    routes = {(m.dilation, m.route) for m in model.modules()
              if isinstance(m, SparseConv) and m.kernel_size == 3}
    assert routes == {(1, "windowed"), (2, "row")}


def test_res16unet14_row_path_step_matches_reference():
    """One SGD step (lr 0.1, momentum 0.9, no schedule)."""
    batch = unet_batch()
    jmodel, model, variables = unets()
    jcfg.parse_config("SGD.momentum = 0.9\n")
    tcfg.parse_config("SGD.momentum = 0.9\n")
    jtask = JTask(jmodel, scheduler_name="none", lr=0.1)
    stash = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    jstate = jstate_of(jmodel, jtask, variables,
                       optax.chain(stash, jtask.make_tx()))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rs, rm = jtask.make_train_step(donate=False).lower(jstate, jb).compile(
        compiler_options=FAST_XLA)(jstate, jb)
    ref_grads = convert.flax_to_state_dict(model,
                                           jax.device_get(rs.opt_state[0]))
    ref_after = convert.flax_to_state_dict(model, {
        "params": jax.device_get(rs.params),
        "batch_stats": jax.device_get(rs.batch_stats)})
    task = SegmentationTraining(model, scheduler_name="none", lr=0.1)
    state = task.create_state()
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    state, mets = task.train_step(state, tb)
    np.testing.assert_allclose(float(mets["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    for key, p in model.named_parameters():
        close_to_largest(p.grad.numpy(), ref_grads[key].numpy(), 1e-5, key)
    for key, v in model.state_dict().items():
        close_to_largest(v.numpy(), ref_after[key].numpy(), 1e-5, key)
