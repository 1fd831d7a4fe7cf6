"""The PyTorch port's packing, coordinate-set algebra and host helpers
against the JAX package: the same numpy inputs through both, outputs
compared exactly (integer keys, coordinates, masks and maps are exact by
construction; averaged features agree to the rounding of their f32 running
sums)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu.data import plenoxel as jdata  # noqa: E402
from nerf_downstream_tpu.data import utils as jutils  # noqa: E402
from nerf_downstream_tpu.sparse import kernels as jk  # noqa: E402
from nerf_downstream_tpu.sparse import packing as jp  # noqa: E402
from nerf_downstream_tpu.sparse.types import (  # noqa: E402
    PointField as JField,
    SparseVoxels as JSV,
)
from nerf_downstream_tpu_torch.data import synthetic as tdata  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as tk  # noqa: E402
from nerf_downstream_tpu_torch.sparse import packing as tp  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import (  # noqa: E402
    PointField as TField,
    SparseVoxels as TSV,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_coords(rng, n=384, valid=300, extent=12, batches=3, dup=True):
    """int32 [n, 4] coords with negative entries, duplicates and invalid
    (masked) rows holding garbage."""
    c = np.zeros((n, 4), np.int32)
    c[:, 0] = rng.integers(0, batches, n)
    c[:, 1:] = rng.integers(-extent, extent, (n, 3))
    if dup:
        c[valid // 2: valid // 2 + 20] = c[:20]
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:valid]] = True
    return c, mask


def u32_as_i32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).view(np.int32)


def t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def assert_eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def test_pack_and_sort_match(rng):
    c, mask = random_coords(rng)
    j_hi, j_lo = jp.pack(jnp.asarray(c), jnp.asarray(mask))
    t_hi, t_lo = tp.pack(t(c), t(mask))
    assert_eq(t_hi, u32_as_i32(j_hi))
    assert_eq(t_lo, u32_as_i32(j_lo))
    idx = np.arange(len(c), dtype=np.int32)
    js = jp.sort_with_payload(j_hi, j_lo, jnp.asarray(idx))
    ts = tp.sort_with_payload(t_hi, t_lo, t(idx))
    for a, b in zip(ts, js):
        assert_eq(a, np.asarray(b).view(np.int32))
    first_j = jp.unique_first_occurrence(js[0], js[1], js[0] != jp.INVALID_KEY)
    first_t = tp.unique_first_occurrence(ts[0], ts[1],
                                         ts[0] != tp.INVALID_KEY)
    assert_eq(first_t, first_j)


def test_sort_key_orders_high_batch_words_unsigned():
    """A batch index >= 1024 puts hi >= 2^31: its keys must still sort
    before the invalid rows, and by unsigned (hi, lo) order."""
    c = np.array([[1500, 3, 0, 0], [2, -5, 1, 1], [1500, -3, 0, 0],
                  [0, 0, 0, 0], [1024, 0, 0, 0]], np.int32)
    mask = np.array([True, True, True, False, True])
    j_hi, j_lo = jp.pack(jnp.asarray(c), jnp.asarray(mask))
    t_hi, t_lo = tp.pack(t(c), t(mask))
    idx = np.arange(len(c), dtype=np.int32)
    j_idx = jp.sort_with_payload(j_hi, j_lo, jnp.asarray(idx))[2]
    t_idx = tp.sort_with_payload(t_hi, t_lo, t(idx))[2]
    assert_eq(t_idx, j_idx)
    assert int(t_idx[-1]) == 3


@pytest.mark.parametrize("n", [512, 500])
def test_search_matches(rng, n):
    """lower_bound, lower_bound_hier (block path at n = 512, linear
    fallback at 500) and find, with hits, misses, masked and past-the-end
    queries."""
    c, mask = random_coords(rng, n=n, valid=n - 60, dup=False)
    j_hi, j_lo = jp.pack(jnp.asarray(c), jnp.asarray(mask))
    js_hi, js_lo = jp.sort_with_payload(j_hi, j_lo)
    qc = np.concatenate([c[:200] + rng.integers(-1, 2, (200, 4)) * [0, 1, 1, 1],
                         c[200:260]]).astype(np.int32)
    qc[:5, 0] = 2047  # beyond every key
    qm = rng.random(len(qc)) < 0.9
    jq_hi, jq_lo = jp.pack(jnp.asarray(qc), jnp.asarray(qm))
    ts_hi, ts_lo = (t(u32_as_i32(js_hi)), t(u32_as_i32(js_lo)))
    tq_hi, tq_lo = (t(u32_as_i32(jq_hi)), t(u32_as_i32(jq_lo)))
    assert_eq(tp.lower_bound(ts_hi, ts_lo, tq_hi, tq_lo),
              jp.lower_bound(js_hi, js_lo, jq_hi, jq_lo))
    assert_eq(tp.lower_bound_hier(ts_hi, ts_lo, tq_hi, tq_lo),
              jp.lower_bound_hier(js_hi, js_lo, jq_hi, jq_lo))
    assert_eq(tp.find(ts_hi, ts_lo, tq_hi, tq_lo),
              jp.find(js_hi, js_lo, jq_hi, jq_lo))
    assert_eq(tp.find(ts_hi, ts_lo, tq_hi, tq_lo, missing=-1),
              jp.find(js_hi, js_lo, jq_hi, jq_lo, missing=-1))


@pytest.mark.parametrize("d", [(1, 1, 1), (-1, -1, -1), (2, 0, -2),
                               (0, -4, 0), (0, 0, 0), (-2, 3, 1)])
def test_shift_keys_match(rng, d):
    c, mask = random_coords(rng)
    c[:10, 2:] = [[-32768, -32768]] * 5 + [[32767, 32767]] * 5  # carries
    j_hi, j_lo = jp.pack(jnp.asarray(c), jnp.asarray(mask))
    assert tp.offset_delta(d) == jp.offset_delta(d)
    dh, dl = jp.offset_delta(d)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else t(m)
        q = jp.shift_keys(j_hi, j_lo, dh, dl, mask=jm)
        r = tp.shift_keys(t(u32_as_i32(j_hi)), t(u32_as_i32(j_lo)), dh, dl,
                          mask=tm)
        assert_eq(r[0], u32_as_i32(q[0]))
        assert_eq(r[1], u32_as_i32(q[1]))


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 4), (2, 2), (2, 8), (1, 1),
                                      ((1, 1, 3), 2)])
def test_kernel_offsets_match(k, stride):
    assert_eq(tk.kernel_offsets(k, stride), jk.kernel_offsets(k, stride))


def test_unique_coords_match(rng):
    c, mask = random_coords(rng)
    jo = jk.unique_coords(jnp.asarray(c), jnp.asarray(mask))
    to = tk.unique_coords(t(c), t(mask))
    for a, b in zip(to, jo):
        assert_eq(a, b)
    # padding rows come out as zero coordinates
    assert not to[0][~to[1]].any()


@pytest.mark.parametrize("cap", [None, 256, 64])
def test_stride_coords_capped_match(rng, cap):
    c, mask = random_coords(rng)
    c[:, 1:] = (c[:, 1:] // 2) * 2
    jsv = JSV(coords=jnp.asarray(c), feats=jnp.zeros((len(c), 3)),
              mask=jnp.asarray(mask), stride=2)
    tsv = TSV(coords=t(c), feats=torch.zeros(len(c), 3), mask=t(mask),
              stride=2)
    jo, jl = jk.stride_coords_capped(jsv, 2, cap)
    to, tl = tk.stride_coords_capped(tsv, 2, cap)
    assert to.stride == jo.stride == 4
    assert_eq(to.coords, jo.coords)
    assert_eq(to.mask, jo.mask)
    assert to.feats.shape == jo.feats.shape
    assert int(tl) == int(jl)
    if cap == 64:
        assert int(tl) > 0


def _fields(rng, n=320, valid=260, c=5, dup=True):
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    if dup:
        pts[100:130] = pts[:30] + 0.01
    coords = np.concatenate(
        [rng.integers(0, 2, (n, 1)).astype(np.float32), pts], 1)
    if dup:
        coords[100:130, 0] = coords[:30, 0]
    feats = rng.normal(size=(n, c)).astype(np.float32)
    mask = np.arange(n) < valid
    jf = JField(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                mask=jnp.asarray(mask))
    tf = TField(coords=t(coords), feats=t(feats), mask=t(mask))
    return jf, tf


@pytest.mark.parametrize("voxel_size", [1.0, 0.5])
def test_field_to_sparse_averaging_match(rng, voxel_size):
    jf, tf = _fields(rng)
    jsv, jp2v = jk.field_to_sparse(jf, voxel_size=voxel_size)
    tsv, tp2v = tk.field_to_sparse(tf, voxel_size=voxel_size)
    assert_eq(tsv.coords, jsv.coords)
    assert_eq(tsv.mask, jsv.mask)
    assert_eq(tp2v, jp2v)
    # run means are differences of f32 running sums over the sorted rows,
    # which XLA and torch associate differently: the error is about
    # rows * 2^-24 * max|running sum| (~1e-5 here), not relative to the mean
    np.testing.assert_allclose(tsv.feats.numpy(), np.asarray(jsv.feats),
                               rtol=1e-6, atol=1e-5)
    # slice back onto the points
    back_j = jk.sparse_to_field(jsv, jf, jp2v)
    back_t = tk.sparse_to_field(tsv, tf, tp2v)
    np.testing.assert_allclose(back_t.feats.numpy(),
                               np.asarray(back_j.feats), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dup", [False, True])
def test_field_to_sparse_assume_unique_match(rng, dup):
    """The unique declaration skips averaging; a violated one NaN-poisons
    every feature in both implementations."""
    jf, tf = _fields(rng, dup=dup)
    if not dup:  # one point per voxel: integer grid positions
        base = rng.permutation(16 ** 3)[:320]
        xyz = np.stack([base // 256, (base // 16) % 16, base % 16], 1) - 8
        coords = np.concatenate([np.zeros((320, 1)), xyz], 1).astype(
            np.float32)
        jf = jf.replace(coords=jnp.asarray(coords))
        tf = TField(coords=t(coords), feats=tf.feats, mask=tf.mask)
    jsv, jp2v = jk.field_to_sparse(jf, assume_unique=True)
    tsv, tp2v = tk.field_to_sparse(tf, assume_unique=True)
    assert_eq(tsv.coords, jsv.coords)
    assert_eq(tsv.mask, jsv.mask)
    assert_eq(tp2v, jp2v)
    np.testing.assert_array_equal(tsv.feats.numpy(), np.asarray(jsv.feats))
    assert bool(torch.isnan(tsv.feats).all()) == dup
    back_j = jk.sparse_to_field(jsv, jf, None)
    back_t = tk.sparse_to_field(tsv, tf, None)
    np.testing.assert_array_equal(back_t.feats.numpy(),
                                  np.asarray(back_j.feats))


@pytest.mark.parametrize("surface", [False, True])
def test_synthetic_scene_and_collate_match(surface):
    """The port's copies of make_synthetic_scene and collate_mink give the
    reference's arrays for the same seed."""
    kw = dict(n_voxels=700, reso=(48, 48, 48), with_labels=True,
              num_classes=20, surface=surface)
    a = tdata.make_synthetic_scene(np.random.default_rng(3), **kw)
    b = jdata.make_synthetic_scene(np.random.default_rng(3), **kw)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    samples = [tdata.scene_sample(np.random.default_rng(s), 300, 20)
               for s in range(3)]
    ta = tdata.collate_mink(samples, capacity=1024)
    ja = jutils.collate_mink(samples, capacity=1024)
    for key in ("coordinates", "features", "mask", "labels", "num_points"):
        np.testing.assert_array_equal(ta[key], ja[key])
