"""Pruned-checkpoint evaluation of the PyTorch port against the JAX package.

The port's weight-sparse helpers and pruning maps must equal the
reference's on the same seeded trees; window plans over padded and ZAXIS
offset sets must be exactly equal; K5's plain version (through
``window_conv_apply_blocksparse``) must match the reference's block-sparse
apply with its Pallas kernel interpreted, at block 4, including a
liveness spec that kills blocks whose weights are not zero. A conv over an
offset subset that is not closed under negation has no escape list, so at
tight windows it poisons its output with NaN, in both packages. (The
whole model in the sparse modes: ``test_torch_port_sparse_model.py``.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu import config as cfg  # noqa: E402
from nerf_downstream_tpu.models.mink.layers import (  # noqa: E402
    SparseConv as JSparseConv,
)
from nerf_downstream_tpu.ops import weight_sparse as jws  # noqa: E402
from nerf_downstream_tpu.ops import window_conv as jwc  # noqa: E402
from nerf_downstream_tpu.sparse import kernels as jk  # noqa: E402
from nerf_downstream_tpu.sparse.context import (  # noqa: E402
    CoordinateContext as JContext,
)
from nerf_downstream_tpu.sparse.types import PointField as JField  # noqa: E402
from nerf_downstream_tpu.sparse.types import SparseVoxels as JVoxels  # noqa: E402
from nerf_downstream_tpu.utils import prune as jprune  # noqa: E402
from nerf_downstream_tpu_torch.models.mink.layers import SparseConv  # noqa: E402
from nerf_downstream_tpu_torch.ops import weight_sparse as tws  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as twc  # noqa: E402
from nerf_downstream_tpu_torch.sparse import CoordinateContext  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as tk  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import SparseVoxels  # noqa: E402
from nerf_downstream_tpu_torch.utils import prune as tprune  # noqa: E402

PADDED = (0, 1, 4, 13, 14, 22, 26)  # (dx, dy) groups of 1, 1, 3, 1, 1
ZAXIS = (4, 13, 22)  # one group of three: G = 1
UNIFORM = (0, 4, 8, 9, 13, 17, 18, 22, 26)  # three groups of 3, symmetric


@pytest.fixture(autouse=True)
def _setup():
    cfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    cfg.clear_config()


def seeded_params(seed=0):
    """A parameter tree shaped like a small Res16UNet's: 3x3x3 and 2x2x2
    conv kernels with whole offsets and whole 4x4 blocks pruned, a 1x1
    kernel, BN leaves."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, shape in (("conv0a_conv", (27, 27, 8)),
                        ("conv1_conv", (8, 8, 8)),
                        ("block1_0", None), ("final", (1, 8, 20)),
                        ("MaskedBatchNorm_0", None)):
        if name == "block1_0":
            tree[name] = {
                "conv1": {"kernel": rng.normal(size=(27, 8, 12))},
                "conv2": {"kernel": rng.normal(size=(27, 12, 12))},
                "downsample_conv": {"kernel": rng.normal(size=(1, 8, 12))},
            }
        elif name == "MaskedBatchNorm_0":
            tree[name] = {"scale": rng.normal(size=8),
                          "bias": rng.normal(size=8)}
        else:
            tree[name] = {"kernel": rng.normal(size=shape)}
    k = tree["block1_0"]["conv1"]["kernel"]
    k[[2, 5, 20]] = 0
    k[:, :4, 4:8] = 0
    tree["conv1_conv"]["kernel"][[1, 6]] = 0
    tree["block1_0"]["conv2"]["kernel"][:, 8:, :] = 0
    # a dead kernel: no offset entry (no live offset), all blocks dead
    tree["conv0a_conv"]["kernel"][:] = 0
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def test_weight_sparse_helpers_match_reference(rng):
    w = rng.normal(size=(27, 10, 6)).astype(np.float32)
    w[[1, 5, 20]] = 0
    w[:, 4:8, 3:] = 0
    for tol in (0.0, 0.5):
        assert (tws.valid_offsets_from_weights(w, tol)
                == jws.valid_offsets_from_weights(w, tol))
    assert tws.sparsity_stats(w) == jws.sparsity_stats(w)
    for k, s in ((3, 1), (2, 2), (3, 4)):
        offs = tk.kernel_offsets(k, s)
        assert tws.zaxis_offsets(offs) == jws.zaxis_offsets(offs)
        np.testing.assert_array_equal(tws.subset_offsets(offs, (0, 1)),
                                      jws.subset_offsets(offs, (0, 1)))
    for block in (3, 4, 128):
        live = tws.block_live_from_weights(w, block)
        np.testing.assert_array_equal(live,
                                      jws.block_live_from_weights(w, block))
        assert tws.block_live_savings(live) == jws.block_live_savings(live)
    offs = tk.kernel_offsets(3, 2)
    for valid in (PADDED, ZAXIS, UNIFORM, (3,), (0, 26)):
        got, want = tws.pad_offset_groups(offs, valid), \
            jws.pad_offset_groups(offs, valid)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_prune_maps_match_reference():
    params = seeded_params()
    vmap = tprune.pruned_offsets_map(params)
    assert vmap == jprune.pruned_offsets_map(params)
    assert set(vmap) == {"block1_0/conv1", "conv1_conv"}
    for block in (4, 5, 128):
        got = tprune.block_live_map(params, block)
        want = jprune.block_live_map(params, block)
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
    assert set(tprune.block_live_map(params, 4)) == {
        "block1_0/conv1", "block1_0/conv2", "conv1_conv", "conv0a_conv"}
    assert (tprune.count_parameters_tree(params)
            == jprune.count_parameters_tree(params))
    pruned, masks = tprune.magnitude_prune(params, 0.3)
    j_pruned, j_masks = jprune.magnitude_prune(params, 0.3)
    assert sorted(masks) == sorted(j_masks)
    for key in masks:
        np.testing.assert_array_equal(masks[key], j_masks[key])
    for (path, a), (_, b) in zip(
            sorted(tprune.flatten(pruned).items()),
            sorted(tprune.flatten(jax.device_get(j_pruned)).items())):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    folded, stats = tprune.fold_pruning_masks(params, masks)
    assert stats == {"folded": len(masks)}
    ref = jprune.apply_masks(params, masks)
    for (path, a), (_, b) in zip(
            sorted(tprune.flatten(folded).items()),
            sorted(tprune.flatten(jax.device_get(ref)).items())):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    assert tprune.fold_pruning_masks(params, {}) == (params, {})


def sorted_level(rng, n=256, valid=220, extent=8, batches=2):
    pts = rng.integers(-extent // 2, extent - extent // 2, (n, 3))
    coords = np.zeros((n, 4), np.float32)
    coords[:, 1:] = pts
    coords[:, 0] = rng.integers(0, batches, n)
    field = JField(coords=jnp.asarray(coords),
                   feats=jnp.zeros((n, 1), jnp.float32),
                   mask=jnp.asarray(np.arange(n) < valid))
    sv, _ = jk.field_to_sparse(field)
    return np.array(sv.coords), np.array(sv.mask)


def assert_plans_equal(port, ref):
    for name in ("starts", "idx", "n_escaped", "esc_k", "esc_i", "esc_j",
                 "esc_stats"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    assert port.perm == ref.perm


@pytest.mark.parametrize("subset", ["padded", "zaxis", "uniform"])
def test_subset_plans_match_reference(rng, monkeypatch, subset):
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    coords, mask = sorted_level(rng)
    full = tk.kernel_offsets(3, 1)
    valid = {"padded": PADDED, "zaxis": ZAXIS, "uniform": UNIFORM}[subset]
    offs = full[list(valid)]
    if subset == "padded":
        offs, rows = tws.pad_offset_groups(full, valid)
        assert (rows < 0).sum() == 8 and len(offs) == 15
    groups = twc.group_offsets(offs)
    assert groups == jwc.group_offsets(offs)
    if subset == "zaxis":
        assert len(groups) == 1 and len(groups[0]) == 3
    nperm = twc.negation_perm(offs)
    ref_nperm = jwc.negation_perm(offs)
    assert (nperm is None) == (ref_nperm is None) == (subset == "padded")
    if nperm is not None:
        for a, b in zip(nperm, ref_nperm):
            np.testing.assert_array_equal(a, b)
    cap = 0 if nperm is None else 2048
    kw = dict(tile=32, window=16, blocks=2, escape_cap=cap, escape_tiles=16)
    for transpose in (False, True):
        ref = jax.jit(lambda c, m: jwc.build_plan_direct(
            c, m, offs, transpose=transpose, **kw))(jnp.asarray(coords),
                                                    jnp.asarray(mask))
        port = twc.build_plan_direct(torch.as_tensor(coords),
                                     torch.as_tensor(mask), offs,
                                     transpose=transpose, **kw)
        assert_plans_equal(port, ref)
        if transpose:
            continue
        derived = twc.transpose_plan(port, offs)
        ref_derived = jwc.transpose_plan(ref, offs)
        assert (derived is None) == (ref_derived is None)
        if derived is not None:
            assert_plans_equal(derived, ref_derived)
    # the context's plan cache keys padded sets by their bytes, duplicates
    # included; the transpose of a padded set is matched afresh
    ctx = CoordinateContext(method="hybrid", window_tile=32, window_size=16,
                            window_blocks=2,
                            window_escape_cap=2048, window_escape_tiles=16)
    c_t, m_t = torch.as_tensor(coords), torch.as_tensor(mask)
    fwd = ctx.window_plan_direct(c_t, m_t, offs)
    assert ctx.window_plan_direct(c_t, m_t, offs) is fwd
    inv = ctx.window_plan_direct(c_t, m_t, offs, transpose=True)
    assert (fwd.esc_k is None) == (subset == "padded")
    assert inv.perm == fwd.perm


def test_blocksparse_plain_matches_interpreted_kernel(rng, monkeypatch):
    """K5's plain version against the reference's Pallas kernel run by the
    interpreter, at block 4: a killed offset, half the blocks dead, then a
    spec that also kills blocks whose weights are not zero (the kernel's
    answer, not the dense one, is the contract)."""
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "interpret")
    coords, mask = sorted_level(rng, n=512, valid=420, extent=12)
    offs = tk.kernel_offsets(3, 1)
    feats = rng.normal(size=(512, 8)).astype(np.float32)
    w = rng.normal(size=(27, 8, 8)).astype(np.float32) * 0.1
    blk = 4
    kill = rng.random((27, 2, 2)) < 0.5
    kill[13] = True
    for k, bi, bo in zip(*np.nonzero(kill)):
        w[k, bi * blk:(bi + 1) * blk, bo * blk:(bo + 1) * blk] = 0
    live = tws.block_live_from_weights(w, blk)
    np.testing.assert_array_equal(live, ~kill)
    b = rng.normal(size=(8,)).astype(np.float32)
    kw = dict(tile=64, window=128, blocks=2)
    ref_plan = jwc.build_plan_direct(jnp.asarray(coords), jnp.asarray(mask),
                                     offs, **kw)
    plan = twc.build_plan_direct(torch.as_tensor(coords),
                                 torch.as_tensor(mask), offs, **kw)
    assert int(plan.n_escaped) == 0
    assert (twc.block_live_spec(live, plan.perm, 9, 3)
            == jwc.block_live_spec(live, ref_plan.perm, 9, 3))
    spec_kill = live & (rng.random(live.shape) < 0.7)  # nonzero blocks dead
    m = mask
    for spec in (live, spec_kill):
        want = jwc.window_conv_apply_blocksparse(
            jnp.asarray(feats), ref_plan, jnp.asarray(w), spec,
            jnp.asarray(b), block=blk)
        got = twc.window_conv_apply_blocksparse(
            torch.as_tensor(feats), plan, torch.as_tensor(w), spec,
            torch.as_tensor(b), block=blk)
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   rtol=1e-5, atol=1e-5)
    # the second spec really changed the answer
    dense = twc.window_conv_apply_blocksparse(
        torch.as_tensor(feats), plan, torch.as_tensor(w), live,
        torch.as_tensor(b), block=blk)
    assert not torch.allclose(dense, got)
    with pytest.raises(RuntimeError, match="forward only"):
        twc.window_conv_apply_blocksparse(
            torch.as_tensor(feats), plan,
            torch.as_tensor(w).requires_grad_(), live, block=blk)


def test_blocksparse_conv_keeps_its_inputs(rng):
    """A conv on the block tier masks its weights and copies its liveness
    once, reuses both on the next forward, and makes them again when its
    kernel is loaded anew; each forward equals the block-sparse apply on
    the kernel of that moment."""
    coords, mask = sorted_level(rng, n=512, valid=420, extent=12)
    feats = torch.as_tensor(rng.normal(size=(512, 8)).astype(np.float32))
    live = rng.random((27, 2, 2)) < 0.5
    live[13] = True
    ctx = CoordinateContext(method="hybrid", window_tile=64, window_size=128,
                            window_blocks=2, block_live_map={"c": live},
                            block_live_granularity=4)
    sv = SparseVoxels(coords=torch.as_tensor(coords), feats=feats,
                      mask=torch.as_tensor(mask), stride=1)
    conv = SparseConv(8, 8, 3, 1)
    conv.path = "c"
    plan = ctx.window_plan_direct(sv.coords, sv.mask, tk.kernel_offsets(3, 1))
    for scale in (0.1, 0.2):
        w = torch.as_tensor(rng.normal(size=(27, 8, 8)).astype(np.float32))
        conv.load_state_dict({"kernel": w * scale})
        with torch.no_grad():
            got = conv(sv, ctx).feats
            kept = conv._bs_cache
            again = conv(sv, ctx).feats
        assert conv.route == "blocksparse" and conv._bs_cache is kept
        want = twc.window_conv_apply_blocksparse(feats, plan, w * scale,
                                                 live, block=4)
        assert torch.equal(got, again) and torch.equal(got, want)
    with pytest.raises(RuntimeError, match="forward only"):
        conv(sv, ctx)


def test_asymmetric_subset_poisons(rng, monkeypatch):
    """A conv over (0, 9, 18) (the (-1, -1) column; its negation is not in
    the set) gets no escape list, so entries beyond its window poison the
    output with NaN, as in the reference; the symmetric set with the
    (1, 1) column added uses the escape list and stays finite."""
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    coords, mask = sorted_level(rng, n=1024, valid=1000, extent=16,
                                batches=1)
    feats = rng.normal(size=(1024, 4)).astype(np.float32)
    w = rng.normal(size=(27, 4, 5)).astype(np.float32)
    knobs = dict(window_tile=32, window_size=16, window_blocks=2,
                 window_escape_cap=4096, window_escape_tiles=64)
    sv = SparseVoxels(coords=torch.as_tensor(coords),
                      feats=torch.as_tensor(feats),
                      mask=torch.as_tensor(mask), stride=1)
    jsv = JVoxels(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                  mask=jnp.asarray(mask), stride=1)
    for valid, poisoned in (((0, 9, 18), True),
                            ((0, 9, 18, 8, 17, 26), False)):
        conv = SparseConv(4, 5, 3, 1, valid_offsets=valid)
        conv.kernel.data = torch.as_tensor(w)
        with torch.no_grad():
            got = conv(sv, CoordinateContext(method="hybrid",
                                             **knobs)).feats.numpy()[mask]
        jconv = JSparseConv(5, 3, 1, valid_offsets=valid)
        ref = np.asarray(jax.jit(lambda v, x: jconv.apply(
            v, x, JContext(method="hybrid", **knobs)).feats)(
            {"params": {"kernel": jnp.asarray(w)}}, jsv))[mask]
        if poisoned:
            assert np.isnan(got).all() and np.isnan(ref).all()
        else:
            assert np.isfinite(got).all() and np.isfinite(ref).all()
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
