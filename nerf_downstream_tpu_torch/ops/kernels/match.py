"""K1 ``window_match``: in-window neighbour indices of a window plan.

Replaces the Pallas TPU kernel ``window_match_pallas``
(``nerf_downstream_tpu/ops/pallas/window_gather.py:387``). The CUDA kernel
is ``window_match.cu`` (its header states the bound on the H100 and the
design); ``window_match_plain`` is the same function in plain PyTorch.

The wrapper dispatches on the device of its tensors: CPU tensors take the
plain version, CUDA tensors launch the kernel, anything else raises.
``window_match.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_downstream_tpu_torch.ops.kernels import build
from nerf_downstream_tpu_torch.sparse import packing

_MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90
_P, _I = ctypes.c_void_p, ctypes.c_int
# hi, lo, n_in, o_hi, o_lo, o_mask, deltas, starts, groups, n_tiles,
# members, tile, cov, idx, stream
_ARGTYPES = (_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P)


def window_match_plain(hi, lo, o_hi, o_lo, out_mask, deltas, starts, tile,
                       window, blocks=2):
    """Plain PyTorch K1: for each (g, t, m, i) the max in-window rank whose
    table key equals the shifted query key, -1 when none (the reference's
    max-of-matches, taken literally over the whole coverage window)."""
    g_count, nt = starts.shape
    m = deltas.shape[1]
    cov = blocks * window
    n_in = hi.shape[0]
    pad = torch.full((cov,), packing.INVALID_KEY, dtype=torch.int32,
                     device=hi.device)
    table = packing.key64(torch.cat([hi, pad]), torch.cat([lo, pad]))
    d = packing.to_u32(deltas)[..., None]  # [G, M, 2, 1]
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
    ``deltas`` int32[G, M, 2]: each (group, member)'s 64-bit key delta as
    (hi, lo) words; ``starts`` int32[G, nT]: window starts. The coverage
    window of tile t in group g is table rows
    [starts[g, t], starts[g, t] + blocks * window).
    """
    dev = hi.device
    if dev.type == "cpu":
        return window_match_plain(hi, lo, o_hi, o_lo, out_mask, deltas,
                                  starts, tile, window, blocks)
    if dev.type != "cuda":
        raise ValueError(f"window_match: unsupported device {dev}")
    g_count, nt = starts.shape
    m = deltas.shape[1]
    n_in = hi.shape[0]
    n = nt * tile
    cov = blocks * window
    build.check_inputs(dev, (
        (hi, "hi", torch.int32, (n_in,)), (lo, "lo", torch.int32, (n_in,)),
        (o_hi, "o_hi", torch.int32, (n,)), (o_lo, "o_lo", torch.int32, (n,)),
        (out_mask, "out_mask", torch.bool, (n,)),
        (deltas, "deltas", torch.int32, (g_count, m, 2)),
        (starts, "starts", torch.int32, (g_count, nt)),
    ))
    if cov * 8 > _MAX_SMEM:
        raise ValueError(f"coverage {cov} rows exceeds the shared memory")
    idx = torch.empty((g_count, nt, m, tile), dtype=torch.int32, device=dev)
    fn = build.function("window_match", "window_match_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            hi.data_ptr(), lo.data_ptr(), n_in, o_hi.data_ptr(),
            o_lo.data_ptr(), out_mask.data_ptr(), deltas.data_ptr(),
            starts.data_ptr(), g_count, nt, m, tile, cov, idx.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"window_match launch failed: CUDA error {err}")
    window_match.launches += 1
    return idx


window_match.launches = 0
