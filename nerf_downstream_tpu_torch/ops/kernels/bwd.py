"""K3 ``window_bwd``: the backward of a windowed sparse conv, d_feats and
d_w over the inverse plan.

Replaces the Pallas TPU kernel ``window_bwd_pallas``
(``nerf_downstream_tpu/ops/pallas/window_gather.py:504``). The CUDA kernel
is ``window_bwd.cu`` (device code shared with K2 and K4 through
``window_gather.cuh`` and ``window_dw.cuh``; its header states the bound
on the H100 and the design): bfloat16 inputs run both halves on the
tensor cores (``window_gather_tc.cuh``, ``window_dw_tc.cuh``, with the
tiles and term split of ``tc.py``), float32 ones on the CUDA cores;
``window_bwd_plain`` is the same function in plain PyTorch: K2's plain
version on the inverse plan for d_feats, and the features times the
gathered gradient rows for d_w.

The wrapper dispatches on the device of its tensors: CPU tensors take the
plain version, CUDA tensors launch the kernel, anything else raises.
``window_bwd.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_downstream_tpu_torch.ops.kernels import build, tc
from nerf_downstream_tpu_torch.ops.kernels.dw import (
    DTYPES,
    dw_scratch,
    gathered_rows,
)
from nerf_downstream_tpu_torch.ops.kernels.gather_matmul import (
    window_gather_matmul_plain,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# g_out, n_out, cout, feats, c, inv_starts, inv_idx, w_t, groups, n_tiles,
# members, tile, chunk_rows, d_feats, part, d_w, bf16, bn, parts, per,
# fpart, bc, bo, stream
_ARGTYPES = (_P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
             _I, _I, _I, _I, _P, _I, _I, _P)


def window_bwd_plain(g_out, feats, inv_starts, inv_idx, w_t):
    """Plain PyTorch K3: (d_feats in the type of ``g_out``, d_w f32)."""
    g_count, _, m, _ = inv_idx.shape
    d_feats = window_gather_matmul_plain(g_out, inv_starts, inv_idx, w_t)
    f = feats.to(torch.float32).T
    d_w = torch.stack([
        torch.stack([f @ gathered_rows(g_out, inv_starts, inv_idx, g, j)
                     for j in range(m)])
        for g in range(g_count)
    ])
    return d_feats, d_w


def window_bwd(g_out, feats, inv_starts, inv_idx, w_t):
    """(d_feats [N_in, C], d_w [G, M, C, Cout] f32) of a windowed conv,
    both over the inverse plan ``inv_starts``/``inv_idx``:
    ``d_feats[j] = sum_{g,m} g_out[inv_starts + inv_idx] @ w_t[g, m]`` and
    ``d_w[g, m] = sum_j feats[j]^T (x) g_out[inv_starts + inv_idx]``.

    ``g_out`` [n_out, Cout] (float32 or bfloat16; rows past ``n_out`` read
    as zero); ``feats`` [N_in, C] with N_in = nT * T of the inverse plan;
    ``inv_starts`` int32[G, nT]; ``inv_idx`` int32[G, nT, M, T];
    ``w_t`` [G, M, Cout, C], all in the type of ``g_out``. d_feats comes
    back in that type.
    """
    dev = g_out.device
    if dev.type == "cpu":
        return window_bwd_plain(g_out, feats, inv_starts, inv_idx, w_t)
    if dev.type != "cuda":
        raise ValueError(f"window_bwd: unsupported device {dev}")
    g_count, nt, m, tile = inv_idx.shape
    n_out, cout = g_out.shape
    c = feats.shape[-1]
    dt = g_out.dtype
    if dt not in DTYPES:
        raise TypeError(f"window_bwd: g_out {dt} unsupported (float32 or "
                        "bfloat16)")
    build.check_inputs(dev, (
        (g_out, "g_out", dt, (n_out, cout)),
        (feats, "feats", dt, (nt * tile, c)),
        (inv_starts, "inv_starts", torch.int32, (g_count, nt)),
        (inv_idx, "inv_idx", torch.int32, (g_count, nt, m, tile)),
        (w_t, "w_t", dt, (g_count, m, cout, c)),
    ))
    n_in = nt * tile
    d_feats = torch.empty((n_in, c), dtype=dt, device=dev)
    d_w = torch.empty((g_count, m, c, cout), dtype=torch.float32, device=dev)
    # d_feats is K2's core on g_out: input width cout, output width c
    choice = tc.gather_choice(dt, n_in, cout, c, g_count * m)
    dw_choice = tc.dw_choice(dt, n_in, c, cout, g_count * m)
    rows_per = dw_choice.chunk_rows
    part = dw_scratch(n_in, d_w.shape, dev, rows_per)
    bc, bo = dw_choice.tiles
    if choice.core == "tensor" and tc.vector_ok(c, cout):
        tc.check_aligned("window_bwd", g_out, feats, w_t)
    fpart = (torch.empty(choice.scratch_numel(n_in, c), dtype=torch.float32,
                         device=dev) if choice.parts > 1 else None)
    fn = build.function("window_bwd", "window_bwd_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            g_out.data_ptr(), n_out, cout, feats.data_ptr(), c,
            inv_starts.data_ptr(), inv_idx.data_ptr(), w_t.data_ptr(),
            g_count, nt, m, tile, rows_per, d_feats.data_ptr(),
            part.data_ptr(), d_w.data_ptr(), int(choice.core == "tensor"),
            choice.column_tile, choice.parts, choice.per,
            None if fpart is None else fpart.data_ptr(), bc, bo, stream,
        )
    if err != 0:
        raise RuntimeError(f"window_bwd launch failed: CUDA error {err}")
    window_bwd.launches += 1
    return d_feats, d_w


window_bwd.launches = 0
