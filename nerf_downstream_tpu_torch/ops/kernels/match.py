"""K1 ``window_match`` and its window-starts pass ``window_starts``: the
window plan of a sorted key table.

K1 replaces the Pallas TPU kernel ``window_match_pallas``
(``nerf_downstream_tpu/ops/pallas/window_gather.py:387``). The pass
computes what the reference's ``build_plan_direct`` computes around it
under ``jit`` (``nerf_downstream_tpu/ops/window_conv.py:241-265``): the
tile-boundary lower bounds, the window starts, each window's last bound
and the escape count. Both kernels are in ``window_match.cu`` (its header
states the bounds on the H100 and the design); ``window_match_plain`` and
``window_starts_plain`` are the same functions in plain PyTorch.

Both take the (group, member) key deltas as Python values, a nested tuple
[G][M] of (hi, lo) int32 words of each member's 64-bit delta, as the
Pallas kernel takes them as static constants: the kernels receive them by
value in their parameters, so no delta tensor is copied to the card.

The wrappers dispatch on the device of their tensors: CPU tensors take
the plain versions, CUDA tensors launch the kernels, anything else raises.
``window_match.launches`` and ``window_starts.launches`` count launches.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_downstream_tpu_torch.ops.kernels import build, tc
from nerf_downstream_tpu_torch.sparse import packing

MAX_TERMS = 32  # (group, member) deltas a launch takes by value
HIER_BLOCK = 256  # rows per block of packing.lower_bound_hier_keys
MIN_ROWS = 32  # fewest rows of a tile one K1 block takes
_MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90
_U32 = 0xFFFFFFFF
_P, _I = ctypes.c_void_p, ctypes.c_int


class Deltas(ctypes.Structure):
    """The kernels' by-value delta parameter: words of term g * M + m."""

    _fields_ = [("hi", ctypes.c_uint32 * MAX_TERMS),
                ("lo", ctypes.c_uint32 * MAX_TERMS)]


# hi, lo, n_in, o_hi, o_lo, o_mask, deltas, starts, groups, n_tiles,
# members, tile, rows, cov, idx, stream
_MATCH_ARGTYPES = (_P, _P, _I, _P, _P, _P, Deltas, _P, _I, _I, _I, _I, _I,
                   _I, _P, _P)
# hi, lo, n_in, o_hi, o_lo, n_valid_in, n_valid_out, deltas, groups,
# members, n_tiles, tile, window, cov, bnd, starts, emax, counts, stream
_STARTS_ARGTYPES = (_P, _P, _I, _P, _P, _P, _P, Deltas, _I, _I, _I, _I, _I,
                    _I, _P, _P, _P, _P, _P)


def pack_deltas(deltas) -> Deltas:
    """The nested [G][M] (hi, lo) words as the kernels' parameter."""
    flat = [d for row in deltas for d in row]
    if len(flat) > MAX_TERMS:
        raise ValueError(f"{len(flat)} (group, member) deltas, at most "
                         f"{MAX_TERMS} per launch")
    out = Deltas()
    for q, (dh, dl) in enumerate(flat):
        out.hi[q] = int(dh) & _U32
        out.lo[q] = int(dl) & _U32
    return out


def _delta_tensor(deltas, device) -> torch.Tensor:
    """uint32 values of the delta words, int64 [G, M, 2], for the plain
    versions."""
    return packing.to_u32(torch.tensor(deltas, dtype=torch.int64,
                                       device=device))


def rows_per_block(n_tiles: int, tile: int, groups: int) -> int:
    """Rows of a tile one K1 block takes: the whole tile, halved while
    the grid would leave the SMs with fewer than ``tc.TARGET_BLOCKS``
    blocks, down to ``MIN_ROWS``."""
    rows = tile
    while (n_tiles * (tile // rows) * groups < tc.TARGET_BLOCKS
           and rows % 2 == 0 and rows // 2 >= MIN_ROWS):
        rows //= 2
    return rows


def window_starts_plain(hi, lo, o_hi, o_lo, n_valid_in, n_valid_out, deltas,
                        tile, window, blocks=2):
    """Plain PyTorch window starts: (starts int32[G, nT], emax int32[G, nT],
    n_escaped int32 scalar), the reference's tile-boundary bounds, window
    starts and escape count, with each (group, member) delta applied
    directly."""
    dev = hi.device
    n = o_hi.shape[0]
    nt = n // tile
    d = _delta_tensor(deltas, dev)  # [G, M, 2]
    g_count, m = d.shape[:2]
    b_valid = torch.arange(nt, device=dev) * tile < n_valid_out
    q = packing.shifted_key64(o_hi[::tile], o_lo[::tile], b_valid,
                              d[:, :, 0, None], d[:, :, 1, None])  # [G, M, nT]
    bnd = packing.lower_bound_hier_keys(packing.key64(hi, lo),
                                        q.reshape(-1)).reshape(g_count, m, nt)
    bnd = torch.where(b_valid, bnd, n_valid_in)
    bnd = torch.cat([bnd, n_valid_in.expand(g_count, m, 1)], 2).to(
        torch.int32)
    smin = bnd[:, :, :-1].amin(1)
    emax = bnd[:, :, 1:].amax(1)
    starts = torch.cummax(smin, 1).values.clamp(min=0)
    starts = (torch.div(starts, window, rounding_mode="floor") * window).to(
        torch.int32).contiguous()
    n_escaped = ((emax - starts) > blocks * window).sum(dtype=torch.int32)
    return starts, emax.contiguous(), n_escaped


def window_starts(hi, lo, o_hi, o_lo, n_valid_in, n_valid_out, deltas, tile,
                  window, blocks=2):
    """(starts int32[G, nT], emax int32[G, nT], n_escaped int32 scalar) of
    a window plan.

    ``hi``/``lo``: the table's sorted packed keys [N_in];
    ``o_hi``/``o_lo``: the query set's keys [N]; ``n_valid_in`` /
    ``n_valid_out``: int32 scalars, the valid rows of each; ``deltas``:
    nested [G][M] (hi, lo) words of each (group, member)'s key delta.
    Tile t of group g has the coverage window [starts[g, t], starts[g, t]
    + blocks * window); emax[g, t] is the last lower bound its rows reach.
    Groups are independent: where one launch's bounds of every (group,
    member, tile) would not fit the shared memory (more than about half a
    million rows of a 27-offset plan), the groups go to launches of their
    own, as many per launch as fit.
    """
    dev = hi.device
    if dev.type == "cpu":
        return window_starts_plain(hi, lo, o_hi, o_lo, n_valid_in,
                                   n_valid_out, deltas, tile, window, blocks)
    if dev.type != "cuda":
        raise ValueError(f"window_starts: unsupported device {dev}")
    return starts_by_groups(_launch_starts, hi, lo, o_hi, o_lo, n_valid_in,
                            n_valid_out, deltas, tile, window, blocks)


def starts_by_groups(launch, hi, lo, o_hi, o_lo, n_valid_in, n_valid_out,
                     deltas, tile, window, blocks):
    """``launch`` (the pass's, or its plain version's, signature) over as
    many groups of ``deltas`` at a time as the pass's shared memory holds
    (4 bytes per (group, member, tile)); starts and emax concatenated by
    group, the escape counts summed."""
    nt = o_hi.shape[0] // tile
    per = max(1, _MAX_SMEM // (4 * len(deltas[0]) * nt))
    if per >= len(deltas):
        return launch(hi, lo, o_hi, o_lo, n_valid_in, n_valid_out, deltas,
                      tile, window, blocks)
    parts = [launch(hi, lo, o_hi, o_lo, n_valid_in, n_valid_out,
                    deltas[g:g + per], tile, window, blocks)
             for g in range(0, len(deltas), per)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]), sum(p[2] for p in parts))


def _launch_starts(hi, lo, o_hi, o_lo, n_valid_in, n_valid_out, deltas,
                   tile, window, blocks):
    """Checks and one launch of the pass (``window_starts``'s CUDA
    branch)."""
    dev = hi.device
    n_in, n = hi.shape[0], o_hi.shape[0]
    g_count, m = len(deltas), len(deltas[0])
    nt = n // tile
    build.check_inputs(dev, (
        (hi, "hi", torch.int32, (n_in,)), (lo, "lo", torch.int32, (n_in,)),
        (o_hi, "o_hi", torch.int32, (n,)), (o_lo, "o_lo", torch.int32, (n,)),
        (n_valid_in, "n_valid_in", torch.int32, ()),
        (n_valid_out, "n_valid_out", torch.int32, ()),
    ))
    if n_in < 1 or nt * tile != n:
        raise ValueError(f"window_starts: {n_in} table rows, {n} query rows "
                         f"in tiles of {tile}")
    tops = n_in // HIER_BLOCK * 8 if n_in % HIER_BLOCK == 0 else 0
    if max(tops, 4 * g_count * m * nt) > _MAX_SMEM:
        raise ValueError(f"window_starts: {n_in} table rows or {nt} tiles "
                         "exceed the shared memory")
    # one allocation: starts, emax, the counts, then the bounds' scratch
    size = g_count * nt
    out = torch.empty(2 * size + g_count + 1 + m * size, dtype=torch.int32,
                      device=dev)
    starts = out[:size].view(g_count, nt)
    emax = out[size:2 * size].view(g_count, nt)
    counts = out[2 * size:2 * size + g_count + 1]
    bnd = out[2 * size + g_count + 1:]
    fn = build.function("window_match", "window_starts_launch",
                        _STARTS_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(hi.data_ptr(), lo.data_ptr(), n_in, o_hi.data_ptr(),
                 o_lo.data_ptr(), n_valid_in.data_ptr(),
                 n_valid_out.data_ptr(), pack_deltas(deltas), g_count, m, nt,
                 tile, window, blocks * window, bnd.data_ptr(),
                 starts.data_ptr(), emax.data_ptr(), counts.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"window_starts launch failed: CUDA error {err}")
    window_starts.launches += 1
    return starts, emax, counts[g_count]


window_starts.launches = 0


def window_match_plain(hi, lo, o_hi, o_lo, out_mask, deltas, starts, tile,
                       window, blocks=2):
    """Plain PyTorch K1: for each (g, t, m, i) the max in-window rank whose
    table key equals the shifted query key, -1 when none (the reference's
    max-of-matches, taken literally over the whole coverage window)."""
    g_count, nt = starts.shape
    cov = blocks * window
    n_in = hi.shape[0]
    d = _delta_tensor(deltas, hi.device)[..., None]  # [G, M, 2, 1]
    m = d.shape[1]
    pad = torch.full((cov,), packing.INVALID_KEY, dtype=torch.int32,
                     device=hi.device)
    table = packing.key64(torch.cat([hi, pad]), torch.cat([lo, pad]))
    q = packing.shifted_key64(o_hi, o_lo, out_mask, d[:, :, 0], d[:, :, 1])
    q = q.reshape(g_count, m, nt, tile)
    span = torch.arange(cov, device=hi.device)
    out = torch.empty((g_count, nt, m, tile), dtype=torch.int32,
                      device=hi.device)
    for g in range(g_count):
        rows = (starts[g].to(torch.int64)[:, None] + span).clamp(
            max=n_in + cov - 1
        )
        win = table[rows]  # [nT, cov]
        for j in range(m):
            eq = win[:, None, :] == q[g, j][:, :, None]  # [nT, T, cov]
            hit = torch.where(eq, span.to(torch.int32), -1).amax(-1)
            out[g, :, j, :] = hit
    return out


def window_match(hi, lo, o_hi, o_lo, out_mask, deltas, starts, tile, window,
                 blocks=2):
    """idx int32[G, nT, M, tile] of a window plan.

    ``hi``/``lo``: the table's sorted packed keys (int32 bit views) [N_in];
    ``o_hi``/``o_lo``/``out_mask``: the query set's keys and validity [N];
    ``deltas``: nested [G][M] (hi, lo) int32 words of each (group,
    member)'s 64-bit key delta; ``starts`` int32[G, nT]: window starts.
    The coverage window of tile t in group g is table rows
    [starts[g, t], starts[g, t] + blocks * window).
    """
    dev = hi.device
    if dev.type == "cpu":
        return window_match_plain(hi, lo, o_hi, o_lo, out_mask, deltas,
                                  starts, tile, window, blocks)
    if dev.type != "cuda":
        raise ValueError(f"window_match: unsupported device {dev}")
    return _launch_match(hi, lo, o_hi, o_lo, out_mask, deltas, starts, tile,
                         window, blocks)


def _launch_match(hi, lo, o_hi, o_lo, out_mask, deltas, starts, tile,
                  window, blocks):
    """Checks and one launch of K1 (``window_match``'s CUDA branch)."""
    dev = hi.device
    g_count, nt = starts.shape
    m = len(deltas[0])
    n_in = hi.shape[0]
    n = nt * tile
    cov = blocks * window
    build.check_inputs(dev, (
        (hi, "hi", torch.int32, (n_in,)), (lo, "lo", torch.int32, (n_in,)),
        (o_hi, "o_hi", torch.int32, (n,)), (o_lo, "o_lo", torch.int32, (n,)),
        (out_mask, "out_mask", torch.bool, (n,)),
        (starts, "starts", torch.int32, (g_count, nt)),
    ))
    if len(deltas) != g_count:
        raise ValueError(f"window_match: {len(deltas)} delta groups for "
                         f"{g_count} plan groups")
    if cov * 8 > _MAX_SMEM:
        raise ValueError(f"coverage {cov} rows exceeds the shared memory")
    idx = torch.empty((g_count, nt, m, tile), dtype=torch.int32, device=dev)
    fn = build.function("window_match", "window_match_launch",
                        _MATCH_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            hi.data_ptr(), lo.data_ptr(), n_in, o_hi.data_ptr(),
            o_lo.data_ptr(), out_mask.data_ptr(), pack_deltas(deltas),
            starts.data_ptr(), g_count, nt, m, tile,
            rows_per_block(nt, tile, g_count), cov, idx.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"window_match launch failed: CUDA error {err}")
    window_match.launches += 1
    return idx


window_match.launches = 0
