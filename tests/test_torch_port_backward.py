"""The gradient side of the port's windowed conv against the JAX package.

K3 ``window_bwd_plain`` and K4 ``window_dw_plain`` against the Pallas
kernels ``window_bwd_pallas`` and ``window_dw_pallas`` run in interpret
mode; K3's d_w over the inverse plan against K4's over the forward plan;
and the d_feats and d_w that autograd takes through ``window_conv_apply``
against ``jax.grad`` of the reference's ``window_conv_apply`` (its XLA
fallback) and of its row conv ``sparse_conv_apply``, for a same-set conv
with escapes, a down conv, a transpose conv, a conv declared
``input_grad=False``, and a plan whose guard NaN-poisons. The reference's
conv runs on the port's plan arrays (the two plan builders agree exactly:
``tests/test_torch_port_plans.py``).

Everything is f32 with inputs from a numpy seed. Tolerances: atol = rtol =
1e-5 between the kernels' plain versions and the Pallas kernels, and
between the two packages' window convs (the same products summed in
another order); 1e-4 against the row conv, as the reference's own
window-against-row test allows (a different algorithm).
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
from nerf_downstream_tpu.ops.sparse_conv import (  # noqa: E402
    sparse_conv_apply,
)
from nerf_downstream_tpu.sparse.context import (  # noqa: E402
    CoordinateContext as JCtx,
)
from nerf_downstream_tpu_torch.ops import kernels as tker  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as twc  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as tk  # noqa: E402
from tests.test_torch_port_plans import (  # noqa: E402
    sorted_level,
    strided_level,
)

TOL = dict(rtol=1e-5, atol=1e-5)
ROW_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    cfg.clear_config()
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "interpret")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    cfg.clear_config()


def plan_pair(kind, rng):
    """(table level, query level, offsets, forward plan kwargs, inverse
    plan kwargs) of a conv: each level a (coords, mask) numpy pair."""
    fine = sorted_level(rng)
    if kind == "same":
        kw = dict(tile=32, window=16, blocks=2, escape_cap=4096,
                  escape_tiles=72)
        return fine, fine, tk.kernel_offsets(3, 1), kw, None
    coarse = strided_level(*fine)
    expand = dict(tile=16, window=16, blocks=6)
    contract = dict(tile=32, window=16, blocks=4, transpose=True)
    if kind == "down":
        return fine, coarse, tk.kernel_offsets(2, 1), expand, contract
    # transpose conv: the down conv's plans with the roles swapped
    return coarse, fine, tk.kernel_offsets(2, 1), contract, expand


def as_jax_plan(plan):
    """The reference's WindowPlan holding the same arrays as a port plan
    (the plan builders agree exactly: tests/test_torch_port_plans.py)."""
    def arr(t):
        return None if t is None else jnp.asarray(t.numpy())

    return jwc.WindowPlan(
        starts=arr(plan.starts), idx=arr(plan.idx),
        n_escaped=arr(plan.n_escaped), esc_k=arr(plan.esc_k),
        esc_i=arr(plan.esc_i), esc_j=arr(plan.esc_j),
        esc_stats=arr(plan.esc_stats), perm=plan.perm, tile=plan.tile,
        window=plan.window, blocks=plan.blocks)


def conv_plans(kind, rng):
    """The conv's (forward, inverse) port plans, its table and query
    levels and its offsets."""
    table, query, offs, kw, inv_kw = plan_pair(kind, rng)

    def build(tab, qry, **k):
        extra = {} if qry is tab else dict(
            out_coords=torch.as_tensor(qry[0]),
            out_mask=torch.as_tensor(qry[1]))
        return twc.build_plan_direct(torch.as_tensor(tab[0]),
                                     torch.as_tensor(tab[1]), offs, **k,
                                     **extra)

    plan = build(table, query, **kw)
    inv = (twc.transpose_plan(plan, offs) if inv_kw is None
           else build(query, table, **inv_kw))
    return (plan, inv), table, query, offs


@pytest.mark.parametrize("kind,c,cout", [("same", 27, 10), ("down", 8, 12)])
def test_k3_plain_matches_pallas(rng, kind, c, cout):
    """d_feats and d_w of one fused backward sweep over the inverse plan,
    with ranks past the gradient table reading zero rows."""
    (_, inv), table, query, _ = conv_plans(kind, rng)
    g, nt, m, tile = inv.idx.shape
    n_out = len(query[0])
    g_out = rng.normal(size=(n_out, cout)).astype(np.float32)
    feats = rng.normal(size=(nt * tile, c)).astype(np.float32)
    w_t = (rng.normal(size=(g, m, cout, c)) * 0.2).astype(np.float32)
    idx = inv.idx.numpy().copy()
    idx[:, -1, :, -3:] = inv.blocks * inv.window - 1  # past the table
    cov = inv.blocks * inv.window
    g_pad = np.concatenate([g_out, np.zeros((cov, cout), np.float32)])
    ref = jax.jit(functools.partial(
        jpl.window_bwd_pallas, tile=tile, window=inv.window,
        compute_dtype=jnp.float32, blocks=inv.blocks))(
        jnp.asarray(g_pad), jnp.asarray(feats),
        jnp.asarray(inv.starts.numpy()), jnp.asarray(idx),
        jnp.asarray(w_t))
    d_feats, d_w = tker.window_bwd_plain(
        torch.as_tensor(g_out), torch.as_tensor(feats), inv.starts,
        torch.as_tensor(idx), torch.as_tensor(w_t))
    assert d_feats.shape == (nt * tile, c) and d_w.shape == (g, m, c, cout)
    np.testing.assert_allclose(d_feats.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(ref[1]), **TOL)
    assert d_w.abs().max() > 1


def test_k4_plain_matches_pallas(rng):
    """d_w of the forward plan with the features gathered, ranks past the
    feature table reading zero rows, at the stem conv's shape (K4 serves
    convs declared input_grad=False: the same-set stem)."""
    c, cout = 27, 32
    (plan, _), table, _, _ = conv_plans("same", rng)
    g, nt, m, tile = plan.idx.shape
    n_in = len(table[0])
    feats = rng.normal(size=(n_in, c)).astype(np.float32)
    g_out = rng.normal(size=(nt * tile, cout)).astype(np.float32)
    idx = plan.idx.numpy().copy()
    idx[:, -1, :, -3:] = plan.blocks * plan.window - 1
    cov = plan.blocks * plan.window
    feats_pad = np.concatenate([feats, np.zeros((cov, c), np.float32)])
    ref = jax.jit(functools.partial(
        jpl.window_dw_pallas, tile=tile, window=plan.window,
        compute_dtype=jnp.float32, blocks=plan.blocks))(
        jnp.asarray(feats_pad), jnp.asarray(plan.starts.numpy()),
        jnp.asarray(idx), jnp.asarray(g_out))
    got = tker.window_dw_plain(torch.as_tensor(feats), plan.starts,
                               torch.as_tensor(idx), torch.as_tensor(g_out))
    assert got.dtype == torch.float32 and got.shape == (g, m, c, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["same", "down", "transpose"])
def test_k3_dw_equals_k4_dw_on_forward_plan(rng, kind):
    """The inverse plan pairs the same (input, output) rows as the forward
    plan (escaped pairs on the side list), so K3's d_w over the inverse
    plan equals K4's over the forward plan."""
    (plan, inv), table, query, _ = conv_plans(kind, rng)
    g, _, m, _ = plan.idx.shape
    feats = torch.as_tensor(rng.normal(size=(len(table[0]), 6)),
                            dtype=torch.float32)
    g_out = torch.as_tensor(rng.normal(size=(len(query[0]), 5)),
                            dtype=torch.float32)
    w_t = torch.zeros(g, m, 5, 6)
    _, dw3 = tker.window_bwd(g_out, feats, inv.starts, inv.idx, w_t)
    dw4 = tker.window_dw(feats, plan.starts, plan.idx, g_out)
    torch.testing.assert_close(dw3, dw4, **TOL)
    assert int((plan.idx >= 0).sum()) == int((inv.idx >= 0).sum())


def _row_maps(table, query, offs, kind):
    """The reference's row-conv kernel map of the conv and its inverse."""
    ctx = JCtx(num_batches=2)
    tc, tm = jnp.asarray(table[0]), jnp.asarray(table[1])
    qc, qm = ((tc, tm) if kind == "same"
              else (jnp.asarray(query[0]), jnp.asarray(query[1])))
    transpose = kind == "transpose"
    fine_stride, coarse_stride = 1, 2
    in_stride = coarse_stride if transpose else fine_stride
    out_stride = (fine_stride if transpose else
                  coarse_stride if kind == "down" else fine_stride)
    km = ctx.kernel_map(tc, tm, qc, qm, offs, transpose=transpose,
                        in_stride=in_stride)
    inv = ctx.kernel_map(qc, qm, tc, tm, offs, transpose=not transpose,
                         in_stride=out_stride)
    return km, inv


CONV_CASES = ["same_escapes", "down", "transpose", "no_input_grad",
              "nan_guard"]


@pytest.mark.parametrize("case", CONV_CASES)
def test_window_conv_grads_match_reference(rng, monkeypatch, case):
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    kind = {"down": "down", "transpose": "transpose"}.get(case, "same")
    (tplan, tinv), table, query, offs = conv_plans(kind, rng)
    input_grad = case != "no_input_grad"
    if case == "nan_guard":
        tinv = dataclasses.replace(tinv, n_escaped=torch.tensor(1))
    if not input_grad:
        tinv = None
    jplan = as_jax_plan(tplan)
    jinv = None if tinv is None else as_jax_plan(tinv)
    n_in, n_out = len(table[0]), len(query[0])
    cin, cout = 6, 5
    feats = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(len(offs), cin, cout)) * 0.3).astype(np.float32)
    gsel = rng.normal(size=(n_out, cout)).astype(np.float32)
    gsel[~query[1]] = 0  # the loss reads the valid output rows only

    def j_loss(f, ww):
        out = jwc.window_conv_apply(f, jplan, jinv, ww,
                                    input_grad=input_grad)
        return jnp.sum(out * gsel)

    ref_f, ref_w = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        jnp.asarray(feats), jnp.asarray(w))
    f_t = torch.as_tensor(feats).requires_grad_()
    w_t = torch.as_tensor(w).requires_grad_()
    out = twc.window_conv_apply(f_t, tplan, tinv, w_t, input_grad=input_grad)
    (out * torch.as_tensor(gsel)).sum().backward()
    got_f, got_w = f_t.grad.numpy(), w_t.grad.numpy()
    if case == "nan_guard":
        assert np.isnan(np.asarray(ref_w)).all() and np.isnan(got_w).all()
        assert np.isnan(got_f[table[1]]).all()
        return
    np.testing.assert_allclose(got_w, np.asarray(ref_w), **TOL)
    np.testing.assert_allclose(got_f, np.asarray(ref_f), **TOL)
    assert np.abs(got_w).max() > 1
    if not input_grad:
        # d_feats is the escape side path's alone, as in the reference
        assert 0 < np.count_nonzero(got_f.any(1)) < table[1].sum()
    # against the row conv (which ignores input_grad: d_w only there)
    km, kinv = _row_maps(table, query, offs, kind)

    def r_loss(f, ww):
        return jnp.sum(sparse_conv_apply(f, km, ww, inv_map=kinv) * gsel)

    row_f, row_w = jax.jit(jax.grad(r_loss, argnums=(0, 1)))(
        jnp.asarray(feats), jnp.asarray(w))
    np.testing.assert_allclose(got_w, np.asarray(row_w), **ROW_TOL)
    if input_grad:
        m = table[1]
        np.testing.assert_allclose(got_f[m], np.asarray(row_f)[m], **ROW_TOL)
