"""Window plans of the PyTorch port against the JAX package.

The same sorted voxel sets go through ``build_plan_direct`` of both
packages; the JAX side runs its match step through the Pallas kernel in
interpret mode (``NDT_WINDOW_PALLAS=interpret``) and through the XLA
fallback (``=0``), the port through the plain version of K1 (the tensors
are on the CPU). ``starts``, ``idx``, ``n_escaped``, the escape list and
its statistics must be exactly equal: same-set plans with the escape list
off, on, and overflowing; expanding and contracting cross-set plans; and
the relabeled transpose plan.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu import config as cfg  # noqa: E402
from nerf_downstream_tpu.ops import window_conv as jwc  # noqa: E402
from nerf_downstream_tpu.sparse import kernels as jk  # noqa: E402
from nerf_downstream_tpu.sparse.types import PointField  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as twc  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as tk  # noqa: E402

PLAN_ARRAYS = ("starts", "idx", "n_escaped", "esc_k", "esc_i", "esc_j",
               "esc_stats")


@pytest.fixture(autouse=True)
def _one_thread():
    cfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    cfg.clear_config()


@pytest.fixture(params=["interpret", "0"])
def jax_mode(request, monkeypatch):
    """The reference's match step: Pallas kernel (interpreted) or XLA."""
    monkeypatch.setenv("NDT_WINDOW_PALLAS", request.param)
    return request.param


@pytest.fixture
def xla_mode(monkeypatch):
    """The reference's XLA match step only (the interpreted Pallas kernel
    costs seconds of tracing per plan; the cases that also run it cover
    the same code)."""
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")


def sorted_level(rng, n=256, valid=220, extent=8, batches=2):
    """(coords int32[n, 4], mask bool[n]) of a level in packed-key order,
    padding rows last, built by the reference's quantization."""
    pts = rng.integers(-extent // 2, extent - extent // 2,
                       (n, 3)).astype(np.float32)
    coords = np.zeros((n, 4), np.float32)
    coords[:, 1:] = pts
    coords[:, 0] = rng.integers(0, batches, n)
    field = PointField(coords=jnp.asarray(coords),
                       feats=jnp.zeros((n, 1), jnp.float32),
                       mask=jnp.asarray(np.arange(n) < valid))
    sv, _ = jk.field_to_sparse(field)
    return np.array(sv.coords), np.array(sv.mask)


def strided_level(coords, mask, stride=2):
    """The next coarser level (reference stride_coords), as numpy."""
    from nerf_downstream_tpu.sparse.types import SparseVoxels

    sv = SparseVoxels(coords=jnp.asarray(coords),
                      feats=jnp.zeros((len(coords), 0)),
                      mask=jnp.asarray(mask), stride=1)
    out = jk.stride_coords(sv, stride)
    return np.array(out.coords), np.array(out.mask)


def assert_plans_equal(port, ref):
    for name in PLAN_ARRAYS:
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    assert port.perm == ref.perm
    assert (port.tile, port.window, port.blocks) == (
        ref.tile, ref.window, ref.blocks)


def both_plans(coords, mask, offs, **kw):
    out_c = kw.pop("out_coords", None)
    out_m = kw.pop("out_mask", None)
    j_extra, t_extra = {}, {}
    if out_c is not None:
        j_extra = dict(out_coords=jnp.asarray(out_c),
                       out_mask=jnp.asarray(out_m))
        t_extra = dict(out_coords=torch.as_tensor(out_c),
                       out_mask=torch.as_tensor(out_m))
    # one traced program: op-by-op dispatch of the escape search would
    # compile each of its few hundred ops separately
    ref = jax.jit(functools.partial(jwc.build_plan_direct, offsets=offs,
                                    **kw))(jnp.asarray(coords),
                                           jnp.asarray(mask), **j_extra)
    port = twc.build_plan_direct(torch.as_tensor(coords),
                                 torch.as_tensor(mask), offs, **kw, **t_extra)
    return port, ref


@pytest.mark.parametrize("mode,escape_cap,expect_overflow", [
    ("interpret", 4096, False), ("0", 4096, False), ("0", 0, True),
    ("0", 3, True)])
def test_same_set_plan_matches(rng, monkeypatch, mode, escape_cap,
                               expect_overflow):
    """Coverage 32 over a dense set: windows overflow, so the escape list
    (both parts: beyond-window entries and mutuality demotions) is busy."""
    monkeypatch.setenv("NDT_WINDOW_PALLAS", mode)
    coords, mask = sorted_level(rng)
    offs = tk.kernel_offsets(3, 1)
    port, ref = both_plans(coords, mask, offs, tile=32, window=16, blocks=2,
                           escape_cap=escape_cap, escape_tiles=72)
    assert_plans_equal(port, ref)
    assert (int(port.n_escaped) > 0) == expect_overflow
    if escape_cap:
        n_gt, n_dt, n_esc = port.esc_stats.tolist()
        assert n_gt > 0 and n_dt > 0 and n_esc > 0
    # the relabeled transpose plan, escape list included
    assert_plans_equal(twc.transpose_plan(port, offs),
                       jwc.transpose_plan(ref, offs))


def test_same_set_plan_wide_window_matches(rng, xla_mode):
    """A window wide enough for every neighbour: nothing escapes, and the
    strided level's offsets (stride 2) group the same way."""
    coords, mask = sorted_level(rng)
    c2, m2 = strided_level(coords, mask)
    offs = tk.kernel_offsets(3, 2)
    port, ref = both_plans(c2, m2, offs, tile=64, window=64, blocks=2,
                           escape_cap=256, escape_tiles=4)
    assert_plans_equal(port, ref)
    assert int(port.n_escaped) == 0 and int(port.esc_stats[2]) == 0


@pytest.mark.parametrize("blocks", [6, 1])
def test_cross_set_plans_match(rng, jax_mode, blocks):
    """A k2/s2 down conv's expanding plan (fine table, coarse queries) and
    its contracting transpose (coarse table, fine queries), as
    ``CoordinateContext.window_plan_cross`` builds them; ``blocks=1``
    makes the expanding plan's windows overflow."""
    coords, mask = sorted_level(rng)
    c2, m2 = strided_level(coords, mask)
    offs = tk.kernel_offsets(2, 1)
    port, ref = both_plans(coords, mask, offs, tile=16, window=16,
                           blocks=blocks, out_coords=c2, out_mask=m2)
    assert_plans_equal(port, ref)
    assert (int(port.n_escaped) > 0) == (blocks == 1)
    port_t, ref_t = both_plans(c2, m2, offs, tile=32, window=16, blocks=4,
                               transpose=True, out_coords=coords,
                               out_mask=mask)
    assert_plans_equal(port_t, ref_t)
    # every fine row finds its one coarse parent
    assert int(port_t.n_escaped) == 0
    assert int((port_t.idx >= 0).sum()) == int(mask.sum())


def test_context_plan_cache_matches_reference(rng, jax_mode):
    """CoordinateContext: per-level escape caps, the transpose derived from
    the cached forward plan, and cross plans with the expand factor."""
    from nerf_downstream_tpu.sparse.context import (
        CoordinateContext as JCtx,
    )
    from nerf_downstream_tpu.sparse.types import SparseVoxels as JSV
    from nerf_downstream_tpu_torch.sparse.context import (
        CoordinateContext as TCtx,
    )
    from nerf_downstream_tpu_torch.sparse.types import SparseVoxels as TSV

    coords, mask = sorted_level(rng)
    knobs = dict(method="hybrid", window_tile=32, window_size=16,
                 window_blocks=2,
                 window_escape_cap=(4096, 0), window_escape_tiles=(72, 2),
                 window_expand_factor=3, level_caps=(256, 128))
    offs = tk.kernel_offsets(3, 1)
    offs2 = tk.kernel_offsets(2, 1)

    def run(ctx, sv):
        plans = [ctx.window_plan_direct(sv.coords, sv.mask, offs,
                                        transpose=t) for t in (False, True)]
        coarse = ctx.strided(sv, 2)
        plans.append(ctx.window_plan_cross(sv, coarse, offs2, expanding=True))
        plans.append(ctx.window_plan_cross(coarse, sv, offs2, transpose=True))
        return plans, coarse.coords

    @jax.jit
    def run_ref(c, m):
        return run(JCtx(num_batches=2, **knobs),
                   JSV(coords=c, feats=jnp.zeros((256, 1)), mask=m))

    ref, ref_coarse = run_ref(jnp.asarray(coords), jnp.asarray(mask))
    port, port_coarse = run(
        TCtx(**knobs),
        TSV(coords=torch.as_tensor(coords), feats=torch.zeros(256, 1),
            mask=torch.as_tensor(mask)))
    np.testing.assert_array_equal(port_coarse.numpy(),
                                  np.asarray(ref_coarse))
    for a, b in zip(port, ref):
        assert_plans_equal(a, b)


def test_plan_cache_holds_its_keys():
    """A cached plan keeps its coordinate tensor alive, so a new tensor can
    never reuse the id of a freed one and be handed a stale plan."""
    import gc

    from nerf_downstream_tpu_torch.sparse.context import CoordinateContext

    ctx = CoordinateContext(method="hybrid", window_tile=64, window_size=32)
    coords = torch.zeros(64, 4, dtype=torch.int32)
    coords[:, 3] = torch.arange(64)
    mask = torch.ones(64, dtype=torch.bool)
    offs = tk.kernel_offsets(3, 1)
    plan = ctx.window_plan_direct(coords, mask, offs)
    key_id = id(coords)
    del coords
    gc.collect()
    (refs, cached), = ctx._window_plans.values()
    assert cached is plan and id(refs[0]) == key_id
