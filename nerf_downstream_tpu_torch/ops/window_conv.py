"""Windowed sparse convolution over key-sorted coordinate sets
(counterpart of ``nerf_downstream_tpu/ops/window_conv.py``).

Every level's coordinates are stored in packed-key order, and the map
"row of coord + d" for a fixed offset d preserves that order. So the
neighbours of a tile of T output rows lie in one contiguous coverage
window of the input table, ``[starts[g, t], starts[g, t] + blocks *
window)``, shared by the offsets of a group (offsets with the same
(dx, dy), which differ only in the fastest key). A plan stores the window
starts and each entry's rank inside its window; the conv gathers and
multiplies by those ranks.

Plan side: ``build_plan`` tiles a monotone row kernel map into window
starts and in-window ranks (the "window" conv method; plain PyTorch, as
the reference's XLA ops). ``build_plan_direct`` finds window starts from tile-boundary
lower bounds (the window-starts pass, ``window_starts``) and the
in-window ranks with K1 (``window_match``): two launches on the card, no
host round trip. The offset order and key deltas of a plan are static
(``plan_layout``), and the index tables derived from them reach the card
through ``consts.const``, once per offset set. With an
escape cap, the few entries whose neighbour falls outside the window (and
entries whose partner in the transpose plan would) go to a short entry
list instead of poisoning the output. ``transpose_plan`` relabels a
same-set plan into its transpose.

Apply side: ``window_conv_apply`` runs K2 (``window_gather_matmul``) and
adds the escape entries with ``ops/scatter.add_rows_``, which adds each
row's entries in a fixed order on the card and on the CPU. For
inference over a pruned
checkpoint, ``window_conv_apply_blocksparse`` runs K5
(``window_gather_matmul_bs``) instead, which skips dead weight blocks.
The gradient of ``window_conv_apply`` is a
``torch.autograd.Function``: K3 (``window_bwd``) gives d_feats and d_w
over the inverse plan, or, for a conv declared ``input_grad=False``, K4
(``window_dw``) gives d_w alone over the forward plan. The escape side
path is plain PyTorch, differentiated by autograd. Every kernel takes its
plain PyTorch version on CPU tensors and launches on CUDA tensors.

Guards: a plan that could not place every entry (``n_escaped > 0``)
NaN-poisons the conv output (fail loud, never a silent truncation).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from nerf_downstream_tpu_torch.ops.consts import const
from nerf_downstream_tpu_torch.ops.kernels import (
    window_bwd,
    window_dw,
    window_gather_matmul,
    window_gather_matmul_bs,
    window_match,
    window_starts,
)
from nerf_downstream_tpu_torch.ops.kernels.gather_matmul_bs import live_mask
from nerf_downstream_tpu_torch.ops.scatter import add_rows_, gather_rows
from nerf_downstream_tpu_torch.sparse import packing

_U32 = 0xFFFFFFFF
# escape search: candidate tiles per equality chunk (bounds the
# [chunk, M, T, slice] compare tensor)
_ESC_CHUNK = 16


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Tiled window layout of one kernel map.

    starts int32[G, nT]; idx int32[G, nT, M, tile] (tile-major, -1 = no
    neighbour); n_escaped int32 scalar (> 0 poisons); the escape list
    esc_k/esc_i/esc_j int32[E] (-1 = padding; esc_k indexes the
    perm-ordered [G * M] weights) and esc_stats int32[3] = [candidate
    tiles, demoted-entry tiles, escape entries]; perm: the kernel-offset
    order of the G x M slots.
    """

    starts: torch.Tensor
    idx: torch.Tensor
    n_escaped: torch.Tensor
    esc_k: torch.Tensor | None = None
    esc_i: torch.Tensor | None = None
    esc_j: torch.Tensor | None = None
    esc_stats: torch.Tensor | None = None
    perm: tuple = ()
    tile: int = 256
    window: int = 512
    blocks: int = 2


def _key(offsets) -> tuple:
    return tuple(tuple(int(v) for v in o) for o in np.asarray(offsets))


def group_offsets(offsets: np.ndarray) -> tuple[tuple[int, ...], ...]:
    """Partition offset indices into equal-size groups sharing (dx, dy)."""
    return _group_offsets(_key(offsets))


@functools.lru_cache(maxsize=None)
def _group_offsets(offsets: tuple) -> tuple[tuple[int, ...], ...]:
    keys: dict[tuple[int, int], list[int]] = {}
    for i, (dx, dy, _dz) in enumerate(offsets):
        keys.setdefault((int(dx), int(dy)), []).append(i)
    groups = tuple(tuple(v) for v in keys.values())
    if len({len(g) for g in groups}) != 1:
        raise ValueError(f"non-uniform offset groups: {groups}")
    return groups


def _i32(v: int) -> int:
    v = int(v) & _U32
    return v - (1 << 32) if v >= (1 << 31) else v


def plan_layout(offsets: np.ndarray, transpose: bool = False) -> tuple:
    """(perm, deltas) of a plan over ``offsets``: the kernel-offset order
    of its G x M (group, member) slots, and each slot's 64-bit packed-key
    delta (of the negated offset when ``transpose``) as nested [G][M]
    (hi, lo) int32 words. Static, so computed once per offset set."""
    return _plan_layout(_key(offsets), bool(transpose))


@functools.lru_cache(maxsize=None)
def _plan_layout(offsets: tuple, transpose: bool) -> tuple:
    groups = _group_offsets(offsets)
    perm = tuple(i for g in groups for i in g)
    m = len(groups[0])
    sign = -1 if transpose else 1
    d64 = [((dh << 32) + dl) & ((1 << 64) - 1) for dh, dl in (
        packing.offset_delta([sign * v for v in o]) for o in offsets)]
    deltas = tuple(
        tuple((_i32(d64[perm[g * m + j]] >> 32), _i32(d64[perm[g * m + j]]))
              for j in range(m))
        for g in range(len(groups)))
    return perm, deltas


def _top_indices(flags: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest flags, ties in ascending index order —
    the order the reference's ``lax.top_k`` returns (``torch.topk`` does
    not fix an order on ties)."""
    return torch.sort(flags.to(torch.int32), descending=True,
                      stable=True).indices[:k]


def window_tile(n: int, tile: int) -> int:
    """The tile of a plan over ``n`` query rows: ``tile``, halved down to 8
    while it does not divide ``n`` (small capacities)."""
    while n % tile and tile > 8:
        tile //= 2
    if n % tile:
        raise ValueError(f"capacity {n} not divisible by window tile {tile}")
    return tile


def build_plan(
    kernel_map: torch.Tensor,
    n_in: int,
    offsets: np.ndarray,
    tile: int = 256,
    window: int = 512,
    expansion: int = 1,
    blocks: int = 2,
) -> WindowPlan:
    """Window plan of a monotone kernel map int32[K, N_out] (``n_in`` =
    no neighbour). ``expansion``: input ranks advanced per output row (a
    map into a coarser set), which shrinks the tile by that factor.

    Each (group, tile) window starts at the smallest neighbour rank of
    the tile (an empty tile inherits the previous start: the maps are
    monotone), quantized down to a multiple of ``window``; entries past
    ``blocks * window`` count in ``n_escaped``. Ranks past the table read
    as zero rows in K2, so the features need no padding."""
    n_out = kernel_map.shape[1]
    tile = window_tile(n_out, max(32, tile // max(int(expansion), 1)))
    nt = n_out // tile
    groups = group_offsets(offsets)
    perm = tuple(i for g in groups for i in g)
    g_count, m = len(groups), len(groups[0])
    km = kernel_map[const(perm, torch.int64, kernel_map.device)].reshape(
        g_count, m, n_out)
    valid = km < n_in
    big = 1 << 30
    gmin = torch.where(valid, km, big).amin(1)  # [G, N_out]
    tmin = gmin.reshape(g_count, nt, tile).amin(2)
    tmin = torch.where(tmin == big, -1, tmin)
    starts = torch.cummax(tmin, 1).values.clamp(min=0)
    starts = (torch.div(starts, window, rounding_mode="floor")
              * window).to(torch.int32)
    rel = km - starts.repeat_interleave(tile, 1)[:, None, :]
    in_win = valid & (rel >= 0) & (rel < blocks * window)
    n_escaped = (valid & ~in_win).sum(dtype=torch.int32)
    idx = torch.where(in_win, rel, -1).to(torch.int32)
    return WindowPlan(
        starts=starts,
        idx=idx.reshape(g_count, m, nt, tile).permute(0, 2, 1, 3).contiguous(),
        n_escaped=n_escaped, perm=perm, tile=tile, window=window,
        blocks=blocks,
    )


def build_plan_direct(
    coords: torch.Tensor,
    mask: torch.Tensor,
    offsets: np.ndarray,
    tile: int = 256,
    window: int = 512,
    transpose: bool = False,
    out_coords: torch.Tensor | None = None,
    out_mask: torch.Tensor | None = None,
    blocks: int = 2,
    escape_cap: int = 0,
    escape_tiles: int = 64,
) -> WindowPlan:
    """Window plan straight from sorted packed keys (no kernel map).

    ``coords``/``mask`` are the table (input) set; cross-set maps pass the
    query (output) set as ``out_coords``/``out_mask``. ``escape_cap > 0``
    (same-set symmetric plans only) enables the escape list.
    """
    if out_coords is None:
        out_coords, out_mask = coords, mask
    dev = coords.device
    n = out_coords.shape[0]
    hi, lo = packing.pack(coords, mask)
    o_hi, o_lo = (
        (hi, lo) if out_coords is coords
        else packing.pack(out_coords, out_mask)
    )
    n_valid_in = mask.sum(dtype=torch.int32)
    n_valid_out = out_mask.sum(dtype=torch.int32)
    tile = window_tile(n, tile)
    nt = n // tile
    perm, deltas = plan_layout(offsets, transpose)
    g_count, m = len(deltas), len(deltas[0])

    # window starts from tile-boundary lower bounds, then the in-window
    # ranks (K1 shifts each query key by its (g, m) 64-bit delta): two
    # launches on the card, with the deltas passed by value
    starts, emax, n_escaped = window_starts(
        hi, lo, o_hi, o_lo, n_valid_in, n_valid_out, deltas, tile, window,
        blocks)
    idx = window_match(hi, lo, o_hi, o_lo, out_mask.contiguous(), deltas,
                       starts, tile, window, blocks)

    esc_k = esc_i = esc_j = esc_stats = None
    if escape_cap > 0:
        if out_coords is not coords:
            raise ValueError(
                "escape_cap applies to same-set plans only (cross-set plans "
                "must size their coverage)"
            )
        nperm = negation_perm(offsets)
        if nperm is None:
            raise ValueError("the escape list needs a symmetric offset set")
        gp = const(nperm[0], torch.int64, dev)
        cov = blocks * window

        def ar(size):
            return torch.arange(size, device=dev)

        # mutuality: pair (k, i -> j) lives in the transpose plan at
        # (k_neg, j) with window starts[g_neg, j // tile]; an in-window j
        # spans at most R = cov // tile + 2 partner tiles from the own
        # window's first tile, so the partner start is an R-way select
        r_vals = cov // tile + 2
        base = torch.div(starts, tile, rounding_mode="floor")
        ps = starts[gp]
        idx_r = (base[:, :, None] + ar(r_vals)).clamp(0, nt - 1)
        s_r = torch.gather(ps, 1, idx_r.reshape(g_count, -1)).reshape(
            g_count, nt, r_vals)
        valid0 = idx >= 0
        j_abs4 = torch.where(valid0, starts[:, :, None, None] + idx, 0)
        r_idx4 = (torch.div(j_abs4, tile, rounding_mode="floor")
                  - base[:, :, None, None])
        inv_start4 = torch.full_like(j_abs4, 1 << 30)
        for r in range(r_vals):
            inv_start4 = torch.where(r_idx4 == r, s_r[:, :, None, None, r],
                                     inv_start4)
        own_i4 = ar(n).reshape(1, nt, 1, tile)
        in_b4 = (own_i4 >= inv_start4) & (own_i4 < inv_start4 + cov)
        demote4 = valid0 & ~in_b4
        idx = torch.where(demote4, -1, idx)

        # part A: entries beyond the window, found by matching the
        # candidate tiles' shifted keys against a [cov + 3 cov) key slice
        slice_w = 4 * cov
        span = emax - starts
        esc_gt = span > cov
        n_gt = esc_gt.sum(dtype=torch.int32)
        n_far = (span > slice_w).sum(dtype=torch.int32)
        te = min(escape_tiles, g_count * nt)
        cand = _top_indices(esc_gt.reshape(-1), te)
        cg, ct = cand // nt, cand % nt
        rows = ct[:, None] * tile + ar(tile)
        mm = ar(m)
        pad = torch.full((slice_w,), -1, dtype=torch.int32, device=dev)
        hi_pad, lo_pad = torch.cat([hi, pad]), torch.cat([lo, pad])
        st_c = starts[cg, ct].to(torch.int64)
        d_c = packing.to_u32(const(deltas, torch.int32, dev))[cg]  # [TE, M, 2]
        q64 = packing.shifted_key64(  # [TE, M, T]
            o_hi[rows][:, None, :], o_lo[rows][:, None, :],
            out_mask[rows][:, None, :], d_c[:, :, 0, None], d_c[:, :, 1, None],
        )
        srows = st_c[:, None] + ar(slice_w)
        s64 = packing.key64(hi_pad[srows], lo_pad[srows])  # [TE, S]
        iota_s = ar(slice_w).to(torch.int32)
        j_loc = torch.empty((te, m, tile), dtype=torch.int32, device=dev)
        for c0 in range(0, te, _ESC_CHUNK):
            c1 = min(te, c0 + _ESC_CHUNK)
            eq = s64[c0:c1, None, None, :] == q64[c0:c1, :, :, None]
            j_loc[c0:c1] = torch.where(eq, iota_s, -1).amax(-1)
        a_flag = j_loc >= cov
        a_k = (cg[:, None, None] * m + mm[None, :, None]).expand(te, m, tile)
        a_i = rows[:, None, :].expand(te, m, tile)
        a_j = st_c[:, None, None] + j_loc

        # part B: in-window entries demoted by the mutuality check
        dem_t = demote4.any(3).any(2)  # [G, nT]
        n_dt = dem_t.sum(dtype=torch.int32)
        cand2 = _top_indices(dem_t.reshape(-1), te)
        cg2, ct2 = cand2 // nt, cand2 % nt
        rows2 = ct2[:, None] * tile + ar(tile)
        b_flag = demote4[cg2, ct2]  # [TE, M, T]
        b_j = j_abs4[cg2, ct2]
        b_k = (cg2[:, None, None] * m + mm[None, :, None]).expand(te, m, tile)
        b_i = rows2[:, None, :].expand(te, m, tile)

        all_flag = torch.cat([a_flag.reshape(-1), b_flag.reshape(-1)])
        all_k = torch.cat([a_k.reshape(-1), b_k.reshape(-1)])
        all_i = torch.cat([a_i.reshape(-1), b_i.reshape(-1)])
        all_j = torch.cat([a_j.reshape(-1), b_j.reshape(-1).to(torch.int64)])
        n_esc = all_flag.sum(dtype=torch.int32)
        e_cap = min(escape_cap, all_flag.shape[0])
        pick = _top_indices(all_flag, e_cap)
        ok = all_flag[pick]
        esc_k = torch.where(ok, all_k[pick], -1).to(torch.int32)
        esc_i = torch.where(ok, all_i[pick], -1).to(torch.int32)
        esc_j = torch.where(ok, all_j[pick], -1).to(torch.int32)
        overflow = (n_gt > te) | (n_dt > te) | (n_esc > e_cap) | (n_far > 0)
        n_escaped = overflow.to(torch.int32)
        esc_stats = torch.stack([n_gt, n_dt, n_esc])

    return WindowPlan(
        starts=starts, idx=idx.contiguous(), n_escaped=n_escaped,
        esc_k=esc_k, esc_i=esc_i, esc_j=esc_j, esc_stats=esc_stats,
        perm=perm, tile=tile, window=window, blocks=blocks,
    )


def negation_perm(offsets: np.ndarray) -> tuple | None:
    """(group_perm, member_perm) relabeling a same-set plan into its
    transpose for a symmetric offset set (every d has -d); None when the
    set is not symmetric or holds duplicates. Callers do not write to the
    arrays (they are computed once per offset set)."""
    return _negation_perm(_key(offsets))


@functools.lru_cache(maxsize=None)
def _negation_perm(offs: tuple) -> tuple | None:
    groups = _group_offsets(offs)
    if len({tuple(int(v) for v in o) for o in offs}) != len(offs):
        return None
    pos: dict[tuple, tuple[int, int]] = {}
    for g, idxs in enumerate(groups):
        for mm, i in enumerate(idxs):
            pos[tuple(int(v) for v in offs[i])] = (g, mm)
    g_perm = np.empty(len(groups), np.int64)
    m_perm = np.empty((len(groups), len(groups[0])), np.int64)
    for g, idxs in enumerate(groups):
        for mm, i in enumerate(idxs):
            neg = tuple(-int(v) for v in offs[i])
            if neg not in pos:
                return None
            g_perm[g], m_perm[g, mm] = pos[neg]
    return g_perm, m_perm


def transpose_plan(plan: WindowPlan, offsets: np.ndarray) -> WindowPlan | None:
    """The transpose (negated-offset) plan of a SAME-SET plan by static
    relabeling: group g takes group g_perm[g]'s windows and member m takes
    member m_perm[g, m]'s ranks; an escape entry (k, i, j) becomes
    (k_neg, j, i). None for an asymmetric offset set."""
    perm = negation_perm(offsets)
    if perm is None:
        return None
    g_perm, m_perm = perm
    dev = plan.starts.device
    esc_k = esc_i = esc_j = None
    m = m_perm.shape[1]
    if plan.esc_k is not None:
        lut = const((g_perm[:, None] * m + m_perm).reshape(-1), torch.int32,
                    dev)
        ok = plan.esc_k >= 0
        esc_k = torch.where(ok, lut[plan.esc_k.clamp(min=0).long()], -1).to(
            torch.int32)
        esc_i, esc_j = plan.esc_j, plan.esc_i
    idx_t = torch.stack([
        torch.stack([plan.idx[int(g_perm[g]), :, int(m_perm[g, mm]), :]
                     for mm in range(m)], 1)
        for g in range(g_perm.shape[0])
    ])
    return dataclasses.replace(
        plan,
        starts=plan.starts[const(g_perm, torch.int64, dev)].contiguous(),
        idx=idx_t.contiguous(),
        esc_k=esc_k, esc_i=esc_i, esc_j=esc_j,
    )


def _esc_scatter(out, feats, esc_k, esc_i, esc_j, w_gm):
    """Escape side path: out[esc_i] += feats[esc_j] @ w_gm[esc_k], in f32
    and added in the output type (plain PyTorch: the reference runs this
    as XLA ops too, never as a kernel, and leaves its gradient to
    autodiff). ``out`` is updated in place; the conv's autograd Functions
    save no output, so autograd can rebase it."""
    valid = esc_j >= 0
    gf = torch.where(valid[:, None], gather_rows(feats, esc_j.clamp(min=0)),
                     0)
    k_count, c, cout = w_gm.shape
    onehot = (esc_k[:, None] == torch.arange(k_count, device=esc_k.device))
    sel = onehot[:, :, None].to(torch.float32) * gf[:, None, :].to(
        torch.float32)
    contrib = sel.reshape(-1, k_count * c) @ w_gm.reshape(
        k_count * c, cout).to(torch.float32)
    upd = torch.where(valid[:, None], contrib, 0.0).to(out.dtype)
    # fixed-order accumulation. The padding entries add zeros to rows of
    # their own; all on one row, the sorted accumulation on the card would
    # add them one after another
    rows = torch.where(valid, esc_i.long(),
                       torch.arange(esc_i.shape[0], device=esc_i.device)
                       % out.shape[0])
    return add_rows_(out, rows, upd)


class _WindowConvCore(torch.autograd.Function):
    """K2 forward; K3 backward over the inverse plan (the reference's
    ``_window_conv_core``). g_out is cast to the compute type, d_feats
    comes back in it, and d_w is computed in f32 and cast to the type of
    the permuted weights."""

    @staticmethod
    def forward(ctx, f, w, starts, idx, inv_starts, inv_idx):
        ctx.save_for_backward(f, w, inv_starts, inv_idx)
        return window_gather_matmul(f, starts, idx, w)

    @staticmethod
    def backward(ctx, g):
        f, w, inv_starts, inv_idx = ctx.saved_tensors
        d_in, d_w = window_bwd(
            g.to(f.dtype).contiguous(), f, inv_starts, inv_idx,
            w.transpose(-1, -2).contiguous(),
        )
        return d_in, d_w.to(w.dtype), None, None, None, None


class _WindowConvCoreDwOnly(torch.autograd.Function):
    """K2 forward; K4 backward over the forward plan, no d_feats (the
    reference's ``_window_conv_core_dw_only``, for convs whose input is
    declared non-differentiated)."""

    @staticmethod
    def forward(ctx, f, w, starts, idx):
        ctx.save_for_backward(f, w, starts, idx)
        return window_gather_matmul(f, starts, idx, w)

    @staticmethod
    def backward(ctx, g):
        f, w, starts, idx = ctx.saved_tensors
        d_w = window_dw(f, starts, idx, g.to(f.dtype).contiguous())
        return None, d_w.to(w.dtype), None, None


def window_conv_apply(
    feats: torch.Tensor,
    plan: WindowPlan,
    inv_plan: WindowPlan | None,
    weights: torch.Tensor,
    bias: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
    input_grad: bool = True,
) -> torch.Tensor:
    """Sparse conv through a window plan: [N_out, Cout] in
    ``compute_dtype`` (f32 accumulation inside K2, one rounding).

    ``weights`` [K, Cin, Cout] in kernel-offset order. ``inv_plan`` is the
    transpose plan the backward gathers along (K3); the forward reads only
    its escape guard. ``input_grad`` False (first-layer convs) declares no
    transpose plan: the backward gives d_w alone (K4) and no d_feats
    beyond the escape side path's.
    """
    if input_grad and (plan.window != inv_plan.window
                       or plan.perm != inv_plan.perm):
        raise ValueError("plan and inverse plan were built with different "
                         "offsets or windows")
    n_in, cin = feats.shape
    g_count, _, m, _ = plan.idx.shape
    # K2 reads ranks past the table as zero rows, so unlike the reference
    # no blocks * window padding rows are appended
    f = feats.to(compute_dtype).contiguous()
    perm = const(plan.perm, torch.int64, feats.device)
    w = weights.to(compute_dtype)[perm].reshape(
        g_count, m, cin, weights.shape[-1]).contiguous()
    if input_grad:
        if inv_plan.idx.shape[1] * inv_plan.idx.shape[3] != n_in:
            raise ValueError("the inverse plan's tiles do not cover the "
                             "input rows")
        out = _WindowConvCore.apply(f, w, plan.starts, plan.idx,
                                    inv_plan.starts, inv_plan.idx)
    else:
        out = _WindowConvCoreDwOnly.apply(f, w, plan.starts, plan.idx)
    if plan.esc_k is not None:
        out = _esc_scatter(out, f, plan.esc_k, plan.esc_i, plan.esc_j,
                           w.reshape(g_count * m, cin, -1))
    bad = plan.n_escaped > 0
    if inv_plan is not None:
        bad = bad | (inv_plan.n_escaped > 0)
    out = out * torch.where(bad, float("nan"), 1.0).to(out.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _member_live(block_live: np.ndarray, perm: tuple, g_count: int,
                 m: int) -> np.ndarray:
    """Per-offset block liveness bool[K', nbi, nbo] (rows in the offset
    order the plan was built from: subset and padding already applied) as
    [G, M, nbi, nbo] in the plan's (group, member) order."""
    bl = np.asarray(block_live)
    return bl[list(perm)].reshape(g_count, m, *bl.shape[1:])


def block_live_spec(block_live: np.ndarray, perm: tuple, g_count: int,
                    m: int) -> tuple:
    """Per-(group, member) live (Cin-block, Cout-block) pairs, as nested
    tuples (the reference bakes this spec into its kernel)."""
    bl = _member_live(block_live, perm, g_count, m)
    return tuple(
        tuple(tuple((int(bi), int(bo)) for bi, bo in np.argwhere(bl[g, j]))
              for j in range(m))
        for g in range(g_count)
    )


def block_live_tensor(block_live: np.ndarray, perm: tuple, g_count: int,
                      m: int, device) -> torch.Tensor:
    """The block liveness as K5 takes it: uint8[G, M, nbi, nbo] on
    ``device``, in the plan's (group, member) order."""
    return torch.as_tensor(
        _member_live(block_live, perm, g_count, m).astype(np.uint8),
        device=device)


def mask_dead_blocks(weights: torch.Tensor, block_live: np.ndarray,
                     block: int) -> torch.Tensor:
    """``weights`` [K', Cin, Cout] with every dead (Cin, Cout) block of
    ``block_live`` bool[K', nbi, nbo] zeroed."""
    live = torch.as_tensor(block_live, device=weights.device)
    return weights * live_mask(live, block, *weights.shape[1:]).to(
        weights.dtype)


def window_conv_apply_blocksparse(
    feats: torch.Tensor,
    plan: WindowPlan,
    weights: torch.Tensor,
    block_live: np.ndarray,
    bias: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
    block: int = 128,
    live: torch.Tensor | None = None,
    masked: bool = False,
) -> torch.Tensor:
    """Inference-only windowed conv that skips dead weight blocks (K5):
    [N_out, Cout] in ``compute_dtype``.

    ``block_live`` bool[K', nbi, nbo] marks the live (Cin, Cout) blocks of
    each offset at granularity ``block``, rows aligned with ``weights``
    [K', Cin, Cout]. A dead pair contributes nothing, whatever its
    weights hold. Forward only; the guard reads the forward plan alone
    (no inverse plan is built on this path), and the escape side path
    multiplies by the weights as given, as in the reference. For a caller
    that keeps both between forwards: ``live`` is ``block_live`` already in
    K5's form (``block_live_tensor``), and ``masked`` says ``weights`` are
    already zero on every dead block (``mask_dead_blocks``), so K5's
    wrapper makes no masked copy.
    """
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or weights.requires_grad):
        raise RuntimeError("the block-sparse conv is forward only: run it "
                           "under torch.no_grad() or inference_mode()")
    cin = feats.shape[1]
    g_count, _, m, _ = plan.idx.shape
    f = feats.to(compute_dtype).contiguous()
    perm = const(plan.perm, torch.int64, feats.device)
    w = weights.to(compute_dtype)[perm].reshape(
        g_count, m, cin, weights.shape[-1]).contiguous()
    if live is None:
        live = block_live_tensor(block_live, plan.perm, g_count, m,
                                 feats.device)
    out = window_gather_matmul_bs(f, plan.starts, plan.idx, w, live, block,
                                  masked=masked)
    if plan.esc_k is not None:
        out = _esc_scatter(out, f, plan.esc_k, plan.esc_i, plan.esc_j,
                           w.reshape(g_count * m, cin, -1))
    out = out * torch.where(plan.n_escaped > 0, float("nan"), 1.0).to(
        out.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
