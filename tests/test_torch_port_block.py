"""The port's block paths and window plans from kernel maps against the
JAX package's, on the CPU.

- ``build_plan`` integer-equal to the reference's (starts, idx, perm,
  tile, n_escaped) on square maps, on strided maps at ``expansion`` 8
  and on a map whose coverage is too short (it escapes).
- The block layout (``block_coords``, ``block_mask``, ``row_slot``,
  ``nbr``, the overflow count) and the level transition integer-equal.
- ``block_conv3``, ``conv3_cells``, ``conv3_zaxis_cells``, ``down_conv2``,
  ``up_conv2``, ``down_sample_conv1`` and ``pool2_cells`` (sum, avg,
  max): forward within rtol 1e-5 and gradients within 1e-5 of the
  largest.
- A block cap that overflows poisons with NaN in both packages;
  ``overflow_guard = False`` is clean.

The reference runs its XLA path, jitted (op by op it would take most
of a minute); the block paths have no Pallas kernel.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu.data.plenoxel import make_synthetic_scene  # noqa: E402
from nerf_downstream_tpu.ops import block_conv as JB  # noqa: E402
from nerf_downstream_tpu.ops import block_resident as JR  # noqa: E402
from nerf_downstream_tpu.ops import window_conv as JW  # noqa: E402
from nerf_downstream_tpu.sparse import context as jctx  # noqa: E402
from nerf_downstream_tpu.sparse import kernels as jk  # noqa: E402
from nerf_downstream_tpu.sparse.types import SparseVoxels as JVoxels  # noqa: E402
from nerf_downstream_tpu_torch.ops import block_conv as TB  # noqa: E402
from nerf_downstream_tpu_torch.ops import block_resident as TR  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as TW  # noqa: E402
from nerf_downstream_tpu_torch.sparse import context as tctx  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as tk  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import SparseVoxels  # noqa: E402

CAP, SCENES, C = 2048, 2, 6


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def shells(seed=0, n_voxels=700, reso=24):
    """SCENES surface shells at ``reso`` in one batch of capacity CAP."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((CAP, 4), np.int32)
    mask = np.zeros(CAP, bool)
    ofs = 0
    for b in range(SCENES):
        sc = make_synthetic_scene(rng, n_voxels=n_voxels, reso=(reso,) * 3,
                                  surface=True)
        n = len(sc["coords"])
        coords[ofs:ofs + n, 0] = b
        coords[ofs:ofs + n, 1:] = sc["coords"]
        mask[ofs:ofs + n] = True
        ofs += n
    feats = rng.normal(size=(CAP, C)).astype(np.float32)
    return coords, mask, feats


def both_levels(coords, mask, feats):
    """The deduplicated level in both packages (same row order)."""
    jc, jm, _ = jax.jit(jk.unique_coords)(jnp.asarray(coords),
                                          jnp.asarray(mask))
    c, m = np.array(jc), np.array(jm)
    jsv = JVoxels(coords=jc, feats=jnp.asarray(feats), mask=jm)
    tsv = SparseVoxels(coords=torch.as_tensor(c), feats=torch.as_tensor(feats),
                       mask=torch.as_tensor(m))
    return jsv, tsv


def same_layout(jl, tl):
    for f in ("block_coords", "block_mask", "row_slot", "row_valid", "nbr"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    assert int(tl.overflow) == int(jl.overflow)
    assert tl.n_blocks == jl.n_blocks


def close_to_largest(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# -- window plans from kernel maps -------------------------------------------

@pytest.mark.parametrize("case", ["square", "strided", "escapes"])
def test_build_plan_matches_reference(case):
    coords, mask, feats = shells(1)
    jsv, tsv = both_levels(coords, mask, feats)
    offs = jk.kernel_offsets(3, 1)
    tile, window, expansion = 256, 512, 1
    out = jsv
    if case == "strided":
        # a coarse level's map into the fine level: 8 fine ranks per row
        out = jax.jit(lambda sv: jk.stride_coords(sv, 2))(jsv)
        offs = jk.kernel_offsets(2, 1)
        expansion = 8
    elif case == "escapes":
        tile, window = 64, 8
    kmj = jax.jit(lambda a, b, c, d: jk.build_kernel_map(a, b, c, d, offs))(
        jsv.coords, jsv.mask, out.coords, out.mask)
    ref = jax.jit(lambda km: JW.build_plan(
        km, CAP, offs, tile=tile, window=window, expansion=expansion))(kmj)
    got = TW.build_plan(torch.as_tensor(np.array(kmj)), CAP, offs,
                        tile=tile, window=window, expansion=expansion)
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(ref.starts))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    assert int(got.n_escaped) == int(ref.n_escaped)
    assert (got.perm, got.tile, got.window, got.blocks) == (
        ref.perm, ref.tile, ref.window, ref.blocks)
    assert (int(got.n_escaped) > 0) == (case == "escapes")


# -- block layouts and transitions -------------------------------------------

@pytest.mark.parametrize("stride,cap", [(1, 512), (2, 256), (1, 40)])
def test_block_layout_matches_reference(stride, cap):
    coords, mask, feats = shells(2)
    jsv, tsv = both_levels(coords, mask, feats)
    if stride > 1:
        jsv = jax.jit(lambda sv: jk.stride_coords(sv, stride))(jsv)
        tsv = tk.stride_coords_capped(tsv, stride, None)[0]
    jl = jax.jit(lambda c, m: JB.build_block_layout(
        c, m, stride, cap, SCENES, grid_extent=64))(jsv.coords, jsv.mask)
    tl = TB.build_block_layout(tsv.coords, tsv.mask, stride, cap, SCENES,
                               grid_extent=64)
    same_layout(jl, tl)
    assert (int(tl.overflow) > 0) == (cap == 40)
    np.testing.assert_array_equal(TR.cell_mask_of(tl).numpy(),
                                  np.asarray(jax.jit(JR.cell_mask_of)(jl)))


def contexts(**knobs):
    knobs = dict(dict(num_batches=SCENES, grid_extent=64,
                      method="block_resident", block_cap_divisor=1), **knobs)
    return jctx.CoordinateContext(**knobs), tctx.CoordinateContext(**knobs)


def resident(jc, tc, jsv, tsv, channels=C, seed=3):
    """The level in dense cells and its step down in both packages,
    random features: (jb, tb, reference transition, port transition)."""
    f = np.random.default_rng(seed).normal(
        size=(tsv.capacity, channels)).astype(np.float32)

    @jax.jit
    def ref(sv):
        jb = jc.to_block(sv)
        return jb, jc.level_transition(jb)

    jb, jtrans = ref(jsv.replace(feats=jnp.asarray(f)))
    tb = tc.to_block(tsv.replace(feats=torch.as_tensor(f)))
    np.testing.assert_array_equal(tb.feats.numpy(), np.asarray(jb.feats))
    return jb, tb, jtrans, tc.level_transition(tb)


def test_level_transition_matches_reference():
    coords, mask, feats = shells(4)
    jsv, tsv = both_levels(coords, mask, feats)
    jc, tc = contexts()
    jb, tb, (jcoarse, jlay, jcm, jt), (tcoarse, tlay, tcm, tt) = resident(
        jc, tc, jsv, tsv)
    np.testing.assert_array_equal(tcoarse.coords.numpy(),
                                  np.asarray(jcoarse.coords))
    same_layout(jlay, tlay)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(tt.slot_base.numpy(),
                                  np.asarray(jt.slot_base))
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    assert tc.level_transition(tb)[3] is tt  # cached


# -- block convs, forward and gradients --------------------------------------

def _grads_match(jfn, tfn, jargs, targs, what):
    """Forward within rtol 1e-5 and every input's gradient within 1e-5 of
    its largest, through the sum with a random cotangent."""
    jout = jax.jit(jfn)(*jargs)
    tout = tfn(*targs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6 * float(
                                   np.abs(np.asarray(jout)).max()),
                               err_msg=what)
    g = np.random.default_rng(9).normal(size=jout.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * g),
                          argnums=tuple(range(len(jargs)))))(*jargs)
    (tout * torch.as_tensor(g)).sum().backward()
    for i, (a, b) in enumerate(zip(targs, jg)):
        close_to_largest(a.grad.numpy(), np.asarray(b), 1e-5, f"{what} d{i}")


def _weights(k, cin, cout, seed=5):
    w = np.random.default_rng(seed).normal(size=(k, cin, cout)).astype(
        np.float32)
    return jnp.asarray(w), torch.tensor(w, requires_grad=True)


def test_block_conv3_matches_reference():
    coords, mask, feats = shells(5)
    jsv, tsv = both_levels(coords, mask, feats)
    jl = jax.jit(lambda c, m: JB.build_block_layout(c, m, 1, 512, SCENES,
                                                    64))(jsv.coords, jsv.mask)
    tl = TB.build_block_layout(tsv.coords, tsv.mask, 1, 512, SCENES, 64)
    jw, tw = _weights(27, C, 5)
    tf = tsv.feats.clone().requires_grad_(True)
    _grads_match(lambda f, w: JB.block_conv3(jl, f, jsv.mask, w),
                 lambda f, w: TB.block_conv3(tl, f, w),
                 (jsv.feats, jw), (tf, tw), "block_conv3")


@functools.lru_cache(maxsize=None)
def cell_case():
    """One resident level and its step down, shared by the cell ops."""
    jsv, tsv = both_levels(*shells(6))
    return resident(*contexts(), jsv, tsv)


@pytest.mark.parametrize("op", ["conv3", "zaxis", "down2", "down1", "up2",
                                "pool_sum", "pool_avg", "pool_max"])
def test_cell_ops_match_reference(op):
    jb, tb, (_, jlay, jcm, jt), (_, tlay, tcm, tt) = cell_case()
    tcells = tb.feats.clone().requires_grad_(True)

    def jbv(cells):
        return jb.replace(feats=cells)

    def tbv(cells):
        return tb.replace(feats=cells)

    if op == "conv3":
        jw, tw = _weights(27, C, 4)
        fns = (lambda x, w: JR.conv3_cells(jbv(x), w),
               lambda x, w: TR.conv3_cells(tbv(x), w))
    elif op == "zaxis":
        jw, tw = _weights(3, C, 4)
        fns = (lambda x, w: JR.conv3_zaxis_cells(jbv(x), w),
               lambda x, w: TR.conv3_zaxis_cells(tbv(x), w))
    elif op == "down2":
        jw, tw = _weights(8, C, 4)
        fns = (lambda x, w: JR.down_conv2(jbv(x), w, jlay, jt, 4),
               lambda x, w: TR.down_conv2(tbv(x), w, tlay, tt))
    elif op == "down1":
        jw, tw = _weights(1, C, 4)
        fns = (lambda x, w: JR.down_sample_conv1(jbv(x), w[0], jlay, jt),
               lambda x, w: TR.down_sample_conv1(tbv(x), w[0], tlay, tt))
    elif op == "up2":
        # the coarse level's cells expand onto this level
        coarse_j, coarse_t = JR.BlockVoxels, TR.BlockVoxels
        cf = np.random.default_rng(8).normal(
            size=(jlay.n_blocks + 1, 4, 4, 4, C)).astype(np.float32)
        cf = np.where(np.asarray(jcm)[..., None], cf, 0).astype(np.float32)
        jco = coarse_j(coords=jb.coords, row_mask=jb.row_mask,
                       feats=jnp.asarray(cf), mask=jcm, layout=jlay, stride=2)
        tco = coarse_t(coords=tb.coords, row_mask=tb.row_mask,
                       feats=torch.as_tensor(cf), mask=tcm, layout=tlay,
                       stride=2)
        tcells = tco.feats.clone().requires_grad_(True)
        jw, tw = _weights(8, C, 4)
        jfine = jb.mask
        fns = (lambda x, w: JR.up_conv2(jco.replace(feats=x), w, jb.layout,
                                        jfine, jt, 4),
               lambda x, w: TR.up_conv2(tco.replace(feats=x), w, tb.mask, tt))
        _grads_match(*fns, (jco.feats, jw), (tcells, tw), op)
        return
    else:
        mode = op.split("_")[1]
        _grads_match(lambda x: JR.pool2_cells(jbv(x), mode, jlay, jt),
                     lambda x: TR.pool2_cells(tbv(x), mode, tlay, tt),
                     (jb.feats,), (tcells,), op)
        return
    _grads_match(*fns, (jb.feats, jw), (tcells, tw), op)


@pytest.mark.parametrize("guard", [True, False])
def test_block_overflow_poisons_as_reference(guard):
    coords, mask, feats = shells(7)
    jsv, tsv = both_levels(coords, mask, feats)
    jc, tc = contexts(block_caps=(40,), overflow_guard=guard)
    jb = jax.jit(jc.to_block)(jsv)
    tb = tc.to_block(tsv)
    assert int(tb.layout.overflow) == int(jb.layout.overflow) > 0
    jrows = np.asarray(jax.jit(JR.to_rows)(jb).feats)
    trows = TR.to_rows(tb).feats.numpy()
    np.testing.assert_array_equal(np.isnan(trows), np.isnan(jrows))
    assert np.isnan(trows).any() == guard
    if not guard:
        np.testing.assert_array_equal(trows, jrows)


@pytest.mark.parametrize("cap,guard", [(40, True), (40, False),
                                       (512, True)])
def test_block_route_overflow_guard(cap, guard):
    """A k3/s1 conv on the "block" route (``SparseConv``): at a block cap
    that overflows the port poisons every row with NaN under
    ``overflow_guard`` (a deliberate difference: the reference drops the
    rows without a block silently, ROADMAP Queue 3); with the guard off,
    and at a cap that fits, its output is the reference's bit for bit
    (integer features and weights: every sum is exact in f32)."""
    from nerf_downstream_tpu.models.mink.layers import SparseConv as JConv
    from nerf_downstream_tpu_torch.models.mink.layers import SparseConv

    coords, mask, _ = shells(7)
    rng = np.random.default_rng(8)
    feats = rng.integers(-3, 4, (CAP, C)).astype(np.float32)
    jsv, tsv = both_levels(coords, mask, feats)
    knobs = dict(method="block", block_caps=(cap,), overflow_guard=guard)
    jc, tc = contexts(**knobs)
    w = rng.integers(-2, 3, (27, C, 5)).astype(np.float32)
    jconv = JConv(5, 3, 1)
    ref = jax.jit(lambda sv: jconv.apply({"params": {"kernel": w}}, sv, jc))(
        jsv)
    conv = SparseConv(C, 5, 3, 1)
    with torch.no_grad():
        conv.kernel.copy_(torch.as_tensor(w))
        out = conv(tsv, tc)
    assert conv.route == "block"
    layout = tc.block_layout(tsv.coords, tsv.mask, tsv.stride)
    assert (int(layout.overflow) > 0) == (cap == 40)
    want = np.asarray(ref.feats)
    got = out.feats.numpy()
    assert np.isfinite(want).all()
    if cap == 40 and guard:
        assert np.isnan(got).all()
    else:
        np.testing.assert_array_equal(got, want)
