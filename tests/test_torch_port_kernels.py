"""The plain versions of the port's two CUDA kernels, and the windowed conv
forward around them, against the JAX package's Pallas kernels run in
interpret mode (and the conv also through the XLA fallback).

K1 ``window_match_plain`` must equal ``window_match_pallas`` exactly; K2
``window_gather_matmul_plain`` and ``window_conv_apply`` must match in f32
within atol = rtol = 1e-5 (the same products summed in another order).
On CPU tensors the wrappers take the plain versions and count no launch.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu import config as cfg  # noqa: E402
from nerf_downstream_tpu.ops import window_conv as jwc  # noqa: E402
from nerf_downstream_tpu.ops.pallas import window_gather as jpl  # noqa: E402
from nerf_downstream_tpu_torch.ops import kernels as tker  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as twc  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as tk  # noqa: E402
from nerf_downstream_tpu_torch.sparse import packing as tp  # noqa: E402
from tests.test_torch_port_plans import (  # noqa: E402
    sorted_level,
    strided_level,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    cfg.clear_config()
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "interpret")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    cfg.clear_config()


def match_inputs(table, query, offs, tile, window, blocks, transpose=False):
    """K1's arguments for a plan of ``offs`` from ``query`` into ``table``
    (each a (coords, mask) pair), with the port's window starts."""
    (c, m), (qc, qm) = table, query
    tc, tm = torch.as_tensor(c), torch.as_tensor(m)
    same = qc is c
    kw = {} if same else dict(out_coords=torch.as_tensor(qc),
                              out_mask=torch.as_tensor(qm))
    plan = twc.build_plan_direct(tc, tm, offs, tile=tile, window=window,
                                 blocks=blocks, transpose=transpose, **kw)
    hi, lo = tp.pack(tc, tm)
    o_hi, o_lo = (hi, lo) if same else tp.pack(kw["out_coords"],
                                               kw["out_mask"])
    o_mask = tm if same else kw["out_mask"]
    signed = -offs if transpose else offs
    d64 = [((dh << 32) + dl) & ((1 << 64) - 1)
           for dh, dl in (tp.offset_delta(d) for d in signed)]
    g_count, _, mm, _ = plan.idx.shape
    deltas = tuple(
        tuple((twc._i32(d64[plan.perm[g * mm + j]] >> 32),
               twc._i32(d64[plan.perm[g * mm + j]])) for j in range(mm))
        for g in range(g_count))
    return (hi, lo, o_hi, o_lo, o_mask, deltas, plan.starts, plan.tile,
            window, blocks), plan


def run_k1_both(args):
    hi, lo, o_hi, o_lo, o_mask, deltas, starts, tile, window, blocks = args
    ref = jax.jit(lambda *a: jpl.window_match_pallas(
        *a[:5], deltas, a[5], tile, window, blocks))(
        *(jnp.asarray(x.numpy()) for x in (hi, lo, o_hi, o_lo, o_mask,
                                           starts)))
    port = tker.window_match_plain(hi, lo, o_hi, o_lo, o_mask, deltas,
                                   starts, tile, window, blocks)
    return port, ref


@pytest.mark.parametrize("tile,window,blocks", [(32, 16, 2), (64, 32, 4)])
def test_k1_same_set_matches_pallas(rng, tile, window, blocks):
    lvl = sorted_level(rng)
    args, plan = match_inputs(lvl, lvl, tk.kernel_offsets(3, 1), tile,
                              window, blocks)
    port, ref = run_k1_both(args)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    # the plan's own idx is this match (no escape list here)
    np.testing.assert_array_equal(port.numpy(), plan.idx.numpy())
    assert (port >= 0).any() and (port < 0).any()


@pytest.mark.parametrize("transpose", [False, True])
def test_k1_cross_set_matches_pallas(rng, transpose):
    """Expanding (coarse queries into the fine table) and contracting
    (fine queries into the coarse table) matches, masked queries
    included."""
    fine = sorted_level(rng)
    coarse = strided_level(*fine)
    table, query = (coarse, fine) if transpose else (fine, coarse)
    args, _ = match_inputs(table, query, tk.kernel_offsets(2, 1), 16, 16, 3,
                           transpose=transpose)
    port, ref = run_k1_both(args)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("c,cout,offs_k", [(27, 16, 3), (16, 8, 3),
                                           (8, 12, 2)])
def test_k2_matches_pallas(rng, c, cout, offs_k):
    """K2 over a real plan's starts and idx, including absent entries and
    ranks that land in the reference's zero padding rows."""
    lvl = sorted_level(rng)
    plan = twc.build_plan_direct(
        torch.as_tensor(lvl[0]), torch.as_tensor(lvl[1]),
        tk.kernel_offsets(offs_k, 1), tile=32, window=16, blocks=4)
    g, nt, m, tile = plan.idx.shape
    n = lvl[0].shape[0]
    feats = rng.normal(size=(n, c)).astype(np.float32)
    w = (rng.normal(size=(g, m, c, cout)) * 0.2).astype(np.float32)
    idx = plan.idx.numpy().copy()
    idx[:, -1, :, -3:] = 63  # past the last row: reads padding (zero)
    cov = plan.blocks * plan.window
    feats_pad = np.concatenate([feats, np.zeros((cov, c), np.float32)])
    ref = jax.jit(functools.partial(
        jpl.window_gather_matmul_pallas, tile=tile, window=plan.window,
        compute_dtype=jnp.float32, blocks=plan.blocks))(
        jnp.asarray(feats_pad), jnp.asarray(plan.starts.numpy()),
        jnp.asarray(idx), jnp.asarray(w))
    port = tker.window_gather_matmul_plain(
        torch.as_tensor(feats), plan.starts, torch.as_tensor(idx),
        torch.as_tensor(w))
    assert port.dtype == torch.float32 and port.shape == (nt * tile, cout)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode", ["interpret", "0"])
def test_window_conv_apply_with_escapes_matches(rng, monkeypatch, mode):
    """The conv forward with the escape list carrying many entries: K2 plus
    the index_add_ side path equal the reference's kernel plus scatter."""
    monkeypatch.setenv("NDT_WINDOW_PALLAS", mode)
    coords, mask = sorted_level(rng)
    offs = tk.kernel_offsets(3, 1)
    kw = dict(tile=32, window=16, blocks=2, escape_cap=4096, escape_tiles=72)
    tplan = twc.build_plan_direct(torch.as_tensor(coords),
                                  torch.as_tensor(mask), offs, **kw)
    jplan = jax.jit(functools.partial(jwc.build_plan_direct, offsets=offs,
                                      **kw))(jnp.asarray(coords),
                                             jnp.asarray(mask))
    assert int(tplan.n_escaped) == 0 and int((tplan.esc_j >= 0).sum()) > 50
    feats = rng.normal(size=(len(coords), 6)).astype(np.float32)
    w = (rng.normal(size=(27, 6, 10)) * 0.2).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    ref = jax.jit(jwc.window_conv_apply)(
        jnp.asarray(feats), jplan, jwc.transpose_plan(jplan, offs),
        jnp.asarray(w), jnp.asarray(b))
    port = twc.window_conv_apply(
        torch.as_tensor(feats), tplan, twc.transpose_plan(tplan, offs),
        torch.as_tensor(w), torch.as_tensor(b))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)
    # a plan that could not place every entry poisons the whole output
    bad = twc.window_conv_apply(
        torch.as_tensor(feats),
        dataclasses.replace(tplan, n_escaped=torch.tensor(1)),
        None, torch.as_tensor(w), input_grad=False)
    assert bool(torch.isnan(bad).all())


def test_wrappers_take_plain_version_on_cpu(rng):
    """CPU tensors run the plain versions and count no kernel launch."""
    lvl = sorted_level(rng)
    args, plan = match_inputs(lvl, lvl, tk.kernel_offsets(3, 1), 32, 16, 2)
    tker.reset_launch_counts()
    idx = tker.window_match(*args)
    assert torch.equal(idx, tker.window_match_plain(*args))
    feats = torch.as_tensor(rng.normal(size=(256, 4)).astype(np.float32))
    w = torch.ones(9, 3, 4, 2)
    for dt in (torch.float32, torch.bfloat16):
        out = tker.window_gather_matmul(feats.to(dt), plan.starts, idx,
                                        w.to(dt))
        assert out.dtype == dt
        assert torch.equal(out, tker.window_gather_matmul_plain(
            feats.to(dt), plan.starts, idx, w.to(dt)))
    assert tker.launch_counts() == {"window_starts": 0, "window_match": 0,
                                    "window_gather_matmul": 0,
                                    "window_bwd": 0, "window_dw": 0,
                                    "window_gather_matmul_bs": 0,
                                    "row_gather_matmul": 0}


def test_wrappers_refuse_other_devices():
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tker.window_gather_matmul(meta, torch.empty(1, 1, device="meta"),
                                  torch.empty(1, 1, 1, 4, device="meta"),
                                  torch.empty(1, 1, 3, 2, device="meta"))
    k = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tker.window_match(k, k, k, k, k.bool(), ((0, 0),),
                          torch.empty(1, 1, device="meta"), 4, 4)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA compiler the build names what is missing."""
    from nerf_downstream_tpu_torch.ops.kernels import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_launch_boundary_checks_inputs():
    """The checks a wrapper makes before handing raw pointers to a kernel."""
    from nerf_downstream_tpu_torch.ops.kernels import build

    cpu = torch.device("cpu")
    ok = torch.zeros(4, 3)
    build.check_inputs(cpu, ((ok, "x", torch.float32, (4, 3)),))
    bad = (
        ((ok, "x", torch.float32, (4, 3)), torch.device("meta"), "is on"),
        ((ok.double(), "x", torch.float32, (4, 3)), cpu, "expected"),
        ((ok[:2], "x", torch.float32, (4, 3)), cpu, "expected shape"),
        ((torch.zeros(3, 4).t(), "x", torch.float32, (4, 3)), cpu,
         "contiguous"),
    )
    for spec, dev, msg in bad:
        with pytest.raises((TypeError, ValueError), match=msg):
            build.check_inputs(dev, (spec,))
