"""K5 ``window_gather_matmul_bs``: the block-sparse forward of a windowed
sparse conv, for pruned checkpoints.

Replaces the Pallas TPU kernel ``window_gather_matmul_pallas_bs``
(``nerf_downstream_tpu/ops/pallas/window_gather.py:284``). The CUDA
kernel is ``window_gather_matmul_bs.cu`` (its header states the bound on
the H100 and the design); ``window_gather_matmul_bs_plain`` is the same
function in plain PyTorch: K2's plain version on the weights multiplied
by the expanded liveness.

The wrapper dispatches on the device of its tensors: CPU tensors take the
plain version, CUDA tensors launch the kernel, anything else raises.
``window_gather_matmul_bs.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_downstream_tpu_torch.ops.kernels import build
from nerf_downstream_tpu_torch.ops.kernels.gather_matmul import (
    window_gather_matmul_plain,
)

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# feats, n_rows, c, starts, idx, w, live, nbi, nbo, block, groups,
# n_tiles, members, tile, cout, out, bf16, stream
_ARGTYPES = (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _P, _I, _P)


def live_mask(live: torch.Tensor, block: int, c: int,
              cout: int) -> torch.Tensor:
    """The liveness [..., nbi, nbo] expanded to a bool [..., C, Cout] mask
    of the weights (edge blocks clamped)."""
    return (live.bool().repeat_interleave(block, -2)
            .repeat_interleave(block, -1)[..., :c, :cout])


def window_gather_matmul_bs_plain(feats, starts, idx, w, live, block: int):
    """Plain PyTorch K5: K2's plain version on ``w`` with every dead
    (Cin-block, Cout-block) pair zeroed."""
    c, cout = w.shape[-2:]
    return window_gather_matmul_plain(
        feats, starts, idx, w * live_mask(live, block, c, cout).to(w.dtype))


def window_gather_matmul_bs(feats, starts, idx, w, live, block: int,
                            masked: bool = False):
    """out [nT * T, Cout] = sum_{g, m} feats[starts[g, t] + idx[g, t, m, i]]
    @ (w[g, m] on its live blocks), f32 accumulation, one rounding into
    the type of ``feats``.

    ``feats`` [N_rows, C] (float32 or bfloat16); ``starts`` int32[G, nT];
    ``idx`` int32[G, nT, M, T] (-1 = absent); ``w`` [G, M, C, Cout] in the
    type of ``feats``; ``live`` uint8[G, M, ceil(C / block),
    ceil(Cout / block)], nonzero = live. ``masked``: ``w`` is already
    zero on every dead block (a caller that keeps its weights so between
    calls); otherwise the wrapper zeroes them first, one elementwise pass.
    """
    dev = feats.device
    if dev.type == "cpu":
        return window_gather_matmul_bs_plain(feats, starts, idx, w, live,
                                             block)
    if dev.type != "cuda":
        raise ValueError(f"window_gather_matmul_bs: unsupported device {dev}")
    g_count, nt, m, tile = idx.shape
    n_rows, c = feats.shape
    cout = w.shape[-1]
    nbi, nbo = -(-c // block), -(-cout // block)
    if feats.dtype not in _DTYPES:
        raise TypeError(f"window_gather_matmul_bs: feats {feats.dtype} "
                        "unsupported (float32 or bfloat16)")
    build.check_inputs(dev, (
        (feats, "feats", feats.dtype, (n_rows, c)),
        (starts, "starts", torch.int32, (g_count, nt)),
        (idx, "idx", torch.int32, (g_count, nt, m, tile)),
        (w, "w", feats.dtype, (g_count, m, c, cout)),
        (live, "live", torch.uint8, (g_count, m, nbi, nbo)),
    ))
    if not masked:
        w = (w * live_mask(live, block, c, cout).to(w.dtype)).contiguous()
    out = torch.empty((nt * tile, cout), dtype=feats.dtype, device=dev)
    fn = build.function("window_gather_matmul_bs",
                        "window_gather_matmul_bs_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            feats.data_ptr(), n_rows, c, starts.data_ptr(), idx.data_ptr(),
            w.data_ptr(), live.data_ptr(), nbi, nbo, block, g_count, nt,
            m, tile, cout, out.data_ptr(),
            int(feats.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"window_gather_matmul_bs launch failed: CUDA error {err}"
        )
    window_gather_matmul_bs.launches += 1
    return out


window_gather_matmul_bs.launches = 0
