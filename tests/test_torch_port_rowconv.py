"""The port's row path (kernel maps, ``sparse_conv_apply``, K6's plain
version) against the JAX package.

Grid-index and search kernel maps, and their inversions, must equal the
reference's exactly: a same-set k3 map, a k2/s2 down map and its
transpose, and the ZAXIS subset of the down map; the coordinate
context's cached maps too. ``sparse_conv_apply``'s forward and both
backwards (scatter-add, and gather through the inverted map) must match
the reference's within 1e-5 relative in f32. K6's plain version must
match ``gather_matmul_reference`` and the Pallas kernel ``gather_matmul``
run by the interpreter.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu.ops import sparse_conv as jsc  # noqa: E402
from nerf_downstream_tpu.ops.pallas import gather_matmul as jgm  # noqa: E402
from nerf_downstream_tpu.sparse import context as jctx  # noqa: E402
from nerf_downstream_tpu.sparse import kernels as jk  # noqa: E402
from nerf_downstream_tpu.sparse.types import PointField as JField  # noqa: E402
from nerf_downstream_tpu.sparse.types import SparseVoxels as JVoxels  # noqa: E402
from nerf_downstream_tpu_torch.ops import kernels as tker  # noqa: E402
from nerf_downstream_tpu_torch.ops import sparse_conv as tsc  # noqa: E402
from nerf_downstream_tpu_torch.ops.weight_sparse import zaxis_offsets  # noqa: E402
from nerf_downstream_tpu_torch.sparse import context as tctx  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as tk  # noqa: E402

BATCHES, EXTENT = 2, 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def levels():
    """(coords, mask) of a sorted level with negative coordinates and its
    stride-2 parent, as numpy, built by the reference."""
    rng = np.random.default_rng(0)
    n, valid = 512, 450
    coords = np.zeros((n, 4), np.float32)
    coords[:, 1:] = rng.integers(-5, EXTENT - 6, (n, 3))
    coords[:, 0] = rng.integers(0, BATCHES, n)
    field = JField(coords=jnp.asarray(coords),
                   feats=jnp.zeros((n, 1), jnp.float32),
                   mask=jnp.asarray(np.arange(n) < valid))
    sv, _ = jk.field_to_sparse(field)
    coarse = jk.stride_coords(sv, 2)
    return ((np.array(sv.coords), np.array(sv.mask)),
            (np.array(coarse.coords), np.array(coarse.mask)))


# (name, table level, query level, kernel, in_stride, subset, transpose)
MAPS = {
    "same_set_k3": (0, 0, 3, 1, None, False),
    "down_k2": (0, 1, 2, 1, None, False),
    "down_k2_zaxis": (0, 1, 2, 1, "zaxis", False),
    "up_k2": (1, 0, 2, 2, None, True),
}


def map_case(levels, name):
    t, q, k, stride, subset, transpose = MAPS[name]
    offs = tk.kernel_offsets(k, 1)
    if subset == "zaxis":
        offs = offs[list(zaxis_offsets(offs))]
    return levels[t], levels[q], offs, stride, transpose


def as_t(arr):
    return torch.as_tensor(np.asarray(arr))


@pytest.mark.parametrize("name", sorted(MAPS))
def test_kernel_maps_match_reference(levels, name):
    (ic, im), (oc, om), offs, stride, transpose = map_case(levels, name)
    grid, origin = tk.build_grid_index(as_t(ic), as_t(im), BATCHES, 32,
                                       stride)
    j_grid, j_origin = jk.build_grid_index(jnp.asarray(ic), jnp.asarray(im),
                                           BATCHES, 32, stride)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(j_grid))
    np.testing.assert_array_equal(origin.numpy(), np.asarray(j_origin))
    km = tk.build_kernel_map_grid(grid, origin, BATCHES, 32, stride,
                                  len(ic), as_t(oc), as_t(om), offs,
                                  transpose)
    j_km = jk.build_kernel_map_grid(j_grid, j_origin, BATCHES, 32, stride,
                                    len(ic), jnp.asarray(oc),
                                    jnp.asarray(om), offs, transpose)
    np.testing.assert_array_equal(km.numpy(), np.asarray(j_km))
    search = tk.build_kernel_map(as_t(ic), as_t(im), as_t(oc), as_t(om),
                                 offs, transpose)
    np.testing.assert_array_equal(search.numpy(), np.asarray(
        jk.build_kernel_map(jnp.asarray(ic), jnp.asarray(im),
                            jnp.asarray(oc), jnp.asarray(om), offs,
                            transpose)))
    np.testing.assert_array_equal(search.numpy(), km.numpy())
    assert km.dtype == torch.int32 and (km < len(ic)).any()
    assert ((km >= 0) & (km <= len(ic))).all()
    inv = tctx.invert_kernel_map(km, len(ic))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(
        jctx.invert_kernel_map(j_km, len(ic))))


@pytest.mark.parametrize("extent", [32, None])
def test_context_kernel_maps_match_reference(levels, extent):
    """The context's maps (grid or search) and its transpose map, derived
    by inverting the cached forward map, equal the reference context's."""
    (ic, im), (oc, om) = levels
    offs = tk.kernel_offsets(2, 1)
    ctx = tctx.CoordinateContext(num_batches=BATCHES, grid_extent=extent)
    j_ctx = jctx.CoordinateContext(num_batches=BATCHES, grid_extent=extent)
    t_in, t_out = (as_t(ic), as_t(im)), (as_t(oc), as_t(om))
    j_in = (jnp.asarray(ic), jnp.asarray(im))
    j_out = (jnp.asarray(oc), jnp.asarray(om))
    km = ctx.kernel_map(*t_in, *t_out, offs, in_stride=1)
    assert ctx.kernel_map(*t_in, *t_out, offs, in_stride=1) is km
    inv = ctx.kernel_map(*t_out, *t_in, offs, transpose=True, in_stride=2)
    np.testing.assert_array_equal(km.numpy(), np.asarray(
        j_ctx.kernel_map(*j_in, *j_out, offs, in_stride=1)))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(
        j_ctx.kernel_map(*j_out, *j_in, offs, transpose=True, in_stride=2)))
    np.testing.assert_array_equal(inv.numpy(), tk.build_kernel_map(
        *t_out, *t_in, offs, transpose=True).numpy())


@pytest.mark.parametrize("name", ["same_set_k3", "down_k2",
                                  "down_k2_zaxis"])
@pytest.mark.parametrize("with_inv", [False, True])
def test_sparse_conv_apply_matches_reference(levels, name, with_inv):
    (ic, im), (oc, om), offs, _, _ = map_case(levels, name)
    km = tk.build_kernel_map(as_t(ic), as_t(im), as_t(oc), as_t(om), offs)
    inv = tctx.invert_kernel_map(km, len(ic)) if with_inv else None
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(len(ic), 6)).astype(np.float32)
    w = rng.normal(size=(len(offs), 6, 5)).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    g = rng.normal(size=(len(oc), 5)).astype(np.float32)

    f_t, w_t, b_t = (torch.tensor(a, requires_grad=True)
                     for a in (feats, w, bias))
    out = tsc.sparse_conv_apply(f_t, km, w_t, b_t, inv_map=inv)
    (out * torch.as_tensor(g)).sum().backward()

    j_km = jnp.asarray(km.numpy())
    j_inv = None if inv is None else jnp.asarray(inv.numpy())

    def loss(f, w_, b):
        o = jsc.sparse_conv_apply(f, j_km, w_, b, inv_map=j_inv)
        return jnp.sum(o * g), o

    (_, ref), grads = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(bias))
    for got, want in ((out.detach(), ref), (f_t.grad, grads[0]),
                      (w_t.grad, grads[1]), (b_t.grad, grads[2])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    assert np.abs(np.asarray(grads[0])).max() > 0


def test_sparse_conv_kernel_volume_one(levels):
    (ic, im), _ = levels
    km = torch.as_tensor(np.where(im, np.arange(len(ic)), len(ic))[None]
                         .astype(np.int32))
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(len(ic), 4)).astype(np.float32)
    w = rng.normal(size=(1, 4, 3)).astype(np.float32)
    tker.reset_launch_counts()
    got = tsc.sparse_conv_apply(torch.as_tensor(feats), km,
                                torch.as_tensor(w))
    want = jsc.sparse_conv_apply(jnp.asarray(feats), jnp.asarray(km.numpy()),
                                 jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert tker.launch_counts()["row_gather_matmul"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_gather_plain_matches_reference(levels, dtype):
    (ic, im), (oc, om), offs, _, _ = map_case(levels, "down_k2")
    km = tk.build_kernel_map(as_t(ic), as_t(im), as_t(oc), as_t(om), offs)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(len(ic) + 1, 7)).astype(np.float32)
    x[-1] = 0
    w = rng.normal(size=(len(offs), 7, 9)).astype(np.float32)
    tdt = getattr(torch, dtype)
    x_t, w_t = torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt)
    got = tker.row_gather_matmul(x_t, km, w_t)
    assert got.dtype == torch.float32 and got.shape == (len(oc), 9)
    assert torch.equal(got, tker.row_gather_matmul_plain(x_t, km, w_t))
    # the same operands the port rounded, handed to the reference
    jx = jnp.asarray(x_t.float().numpy()).astype(dtype)
    jw = jnp.asarray(w_t.float().numpy()).astype(dtype)
    want = np.asarray(jgm.gather_matmul_reference(jx, jnp.asarray(
        km.numpy()), jw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the Pallas kernel, interpreted (it needs N_out % 128 == 0)
    n_out = len(oc) // 128 * 128
    want = np.asarray(jgm.gather_matmul(jx, jnp.asarray(km.numpy()[:, :n_out]),
                                        jw, tile_n=128, interpret=True))
    np.testing.assert_allclose(got.numpy()[:n_out], want, rtol=1e-5,
                               atol=1e-5)
    # all-sentinel offsets add nothing
    empty = torch.full_like(km, len(ic))
    assert not tker.row_gather_matmul(x_t, empty, w_t).any()
