"""K4 ``window_dw``: the weight gradient of a windowed sparse conv whose
input takes no gradient (the stem conv).

Replaces the Pallas TPU kernel ``window_dw_pallas``
(``nerf_downstream_tpu/ops/pallas/window_gather.py:590``). The CUDA kernel
is ``window_dw.cu`` (its header states the bound on the H100 and the
design): bfloat16 inputs run K3's tensor-core d_w (``window_dw_tc.cuh``)
with the features as the gathered side, float32 ones the CUDA-core d_w
(``window_dw.cuh``), with the tiles and row chunks of
``tc.dw_choice``; ``window_dw_plain`` is the same function in plain
PyTorch, mirroring the reference's ``_window_dw``
(``nerf_downstream_tpu/ops/window_conv.py:716``).

The wrapper dispatches on the device of its tensors: CPU tensors take the
plain version, CUDA tensors launch the kernel, anything else raises.
``window_dw.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_downstream_tpu_torch.ops.kernels import build, tc

DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# feats, n_in, c, starts, idx, g_out, cout, groups, n_tiles, members, tile,
# chunk_rows, part, d_w, bf16, bc, bo, stream
_ARGTYPES = (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I,
             _I, _P)


def dw_scratch(rows: int, d_w_shape, device,
               per: int) -> torch.Tensor:
    """f32 scratch for the partials of d_w over ``rows`` rows in chunks
    of ``per`` rows (one element when there is one chunk: the kernel then
    writes d_w itself). d_w is summed per chunk, each partial added in a
    fixed order afterwards (``dw_reduce_kernel``)."""
    chunks = -(-rows // per)
    numel = 1
    for s in d_w_shape:
        numel *= s
    return torch.empty(numel * chunks if chunks > 1 else 1,
                       dtype=torch.float32, device=device)


def gathered_rows(src, starts, idx, g: int, j: int) -> torch.Tensor:
    """f32 [nT * T, C]: row t*T + i is ``src[starts[g, t] + idx[g, t, j,
    i]]``, zero where the entry is absent or lands past the table."""
    n_rows = src.shape[0]
    k = idx[g, :, j, :].to(torch.int64)
    rows = starts[g].to(torch.int64)[:, None] + k
    present = ((k >= 0) & (rows < n_rows)).reshape(-1, 1)
    return torch.where(
        present, src[rows.clamp(0, n_rows - 1).reshape(-1)].to(torch.float32),
        0.0)


def window_dw_plain(feats, starts, idx, g_out):
    """Plain PyTorch K4: per (g, m), the gathered feature rows (zero where
    absent or past the table), transposed, times ``g_out``, in f32."""
    g_count, _, m, _ = idx.shape
    go = g_out.to(torch.float32)
    return torch.stack([
        torch.stack([gathered_rows(feats, starts, idx, g, j).T @ go
                     for j in range(m)])
        for g in range(g_count)
    ])


def window_dw(feats, starts, idx, g_out):
    """d_w [G, M, C, Cout] f32 = sum over (t, i) of
    ``feats[starts[g, t] + idx[g, t, m, i]]^T (x) g_out[t * T + i]``.

    ``feats`` [N_in, C] (float32 or bfloat16); ``starts`` int32[G, nT];
    ``idx`` int32[G, nT, M, T] (tile-major, -1 = absent; ranks past the
    table add nothing); ``g_out`` [nT * T, Cout] in the type of ``feats``.
    """
    dev = feats.device
    if dev.type == "cpu":
        return window_dw_plain(feats, starts, idx, g_out)
    if dev.type != "cuda":
        raise ValueError(f"window_dw: unsupported device {dev}")
    g_count, nt, m, tile = idx.shape
    n_in, c = feats.shape
    cout = g_out.shape[-1]
    if feats.dtype not in DTYPES:
        raise TypeError(f"window_dw: feats {feats.dtype} unsupported "
                        "(float32 or bfloat16)")
    build.check_inputs(dev, (
        (feats, "feats", feats.dtype, (n_in, c)),
        (starts, "starts", torch.int32, (g_count, nt)),
        (idx, "idx", torch.int32, (g_count, nt, m, tile)),
        (g_out, "g_out", feats.dtype, (nt * tile, cout)),
    ))
    d_w = torch.empty((g_count, m, c, cout), dtype=torch.float32, device=dev)
    choice = tc.dw_choice(feats.dtype, nt * tile, c, cout, g_count * m)
    part = dw_scratch(nt * tile, d_w.shape, dev, choice.chunk_rows)
    if choice.core == "tensor" and tc.vector_ok(c, cout):
        tc.check_aligned("window_dw", feats, g_out)
    bc, bo = choice.tiles
    fn = build.function("window_dw", "window_dw_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            feats.data_ptr(), n_in, c, starts.data_ptr(), idx.data_ptr(),
            g_out.data_ptr(), cout, g_count, nt, m, tile, choice.chunk_rows,
            part.data_ptr(), d_w.data_ptr(), int(choice.core == "tensor"),
            bc, bo, stream,
        )
    if err != 0:
        raise RuntimeError(f"window_dw launch failed: CUDA error {err}")
    window_dw.launches += 1
    return d_w


window_dw.launches = 0
