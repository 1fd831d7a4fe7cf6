"""K2 ``window_gather_matmul``: the forward of a windowed sparse conv.

Replaces the Pallas TPU kernel ``window_gather_matmul_pallas``
(``nerf_downstream_tpu/ops/pallas/window_gather.py:131``). The CUDA kernel
is ``window_gather_matmul.cu`` (its header states the bound on the H100
and the design): bfloat16 inputs run on the tensor cores, float32 ones on
the CUDA cores, with the column tile and term split of ``tc.py``;
``window_gather_matmul_plain`` is the same function in plain PyTorch.

The wrapper dispatches on the device of its tensors: CPU tensors take the
plain version, CUDA tensors launch the kernel, anything else raises.
``window_gather_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_downstream_tpu_torch.ops.kernels import build, tc

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# feats, n_rows, c, starts, idx, w, groups, n_tiles, members, tile, cout,
# out, bf16, bn, parts, per, part, stream
_ARGTYPES = (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I,
             _P, _P)


def window_gather_matmul_plain(feats, starts, idx, w):
    """Plain PyTorch K2: per (g, m), gather rows ``starts + idx`` (absent
    entries and ranks past the table give zero rows), multiply by
    ``w[g, m]`` and accumulate in f32; round once into the input type."""
    g_count, nt, m, tile = idx.shape
    n_rows, c = feats.shape
    n_out = nt * tile
    f = feats.to(torch.float32)
    acc = torch.zeros((n_out, w.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for g in range(g_count):
        for j in range(m):
            k = idx[g, :, j, :].to(torch.int64)
            rows = starts[g].to(torch.int64)[:, None] + k
            present = (k >= 0) & (rows < n_rows)
            gathered = torch.where(
                present.reshape(n_out, 1),
                f[rows.clamp(0, n_rows - 1).reshape(n_out)],
                0.0,
            )
            acc += gathered @ w[g, j].to(torch.float32)
    return acc.to(feats.dtype)


def window_gather_matmul(feats, starts, idx, w):
    """out [nT * T, Cout] = sum_{g, m} feats[starts[g, t] + idx[g, t, m, i]]
    @ w[g, m], f32 accumulation, one rounding into the type of ``feats``.

    ``feats`` [N_rows, C] (float32 or bfloat16); ``starts`` int32[G, nT];
    ``idx`` int32[G, nT, M, T] (tile-major, -1 = absent); ``w``
    [G, M, C, Cout] in the type of ``feats``.
    """
    dev = feats.device
    if dev.type == "cpu":
        return window_gather_matmul_plain(feats, starts, idx, w)
    if dev.type != "cuda":
        raise ValueError(f"window_gather_matmul: unsupported device {dev}")
    g_count, nt, m, tile = idx.shape
    n_rows, c = feats.shape
    cout = w.shape[-1]
    if feats.dtype not in _DTYPES:
        raise TypeError(f"window_gather_matmul: feats {feats.dtype} "
                        "unsupported (float32 or bfloat16)")
    build.check_inputs(dev, (
        (feats, "feats", feats.dtype, (n_rows, c)),
        (starts, "starts", torch.int32, (g_count, nt)),
        (idx, "idx", torch.int32, (g_count, nt, m, tile)),
        (w, "w", feats.dtype, (g_count, m, c, cout)),
    ))
    n_out = nt * tile
    out = torch.empty((n_out, cout), dtype=feats.dtype, device=dev)
    choice = tc.gather_choice(feats.dtype, n_out, c, cout, g_count * m)
    if choice.core == "tensor" and tc.vector_ok(c, cout):
        tc.check_aligned("window_gather_matmul", feats, w)
    part = (torch.empty(choice.scratch_numel(n_out, cout),
                        dtype=torch.float32, device=dev)
            if choice.parts > 1 else None)
    fn = build.function("window_gather_matmul",
                        "window_gather_matmul_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            feats.data_ptr(), n_rows, c, starts.data_ptr(), idx.data_ptr(),
            w.data_ptr(), g_count, nt, m, tile, cout, out.data_ptr(),
            int(choice.core == "tensor"), choice.column_tile, choice.parts,
            choice.per, None if part is None else part.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"window_gather_matmul launch failed: CUDA error {err}"
        )
    window_gather_matmul.launches += 1
    return out


window_gather_matmul.launches = 0
