"""K5 ``window_gather_matmul_bs``: the block-sparse forward of a windowed
sparse conv, for pruned checkpoints.

Replaces the Pallas TPU kernel ``window_gather_matmul_pallas_bs``
(``nerf_downstream_tpu/ops/pallas/window_gather.py:284``). The CUDA
kernel is ``window_gather_matmul_bs.cu`` (its header states the bound on
the H100 and the design): bfloat16 inputs run K2's tensor-core core with
a liveness policy and K2's column tile and term split
(``tc.gather_choice``), float32 ones the CUDA-core core;
``window_gather_matmul_bs_plain`` is the same function in plain PyTorch:
K2's plain version on the weights multiplied by the expanded liveness.

The wrapper dispatches on the device of its tensors: CPU tensors take the
plain version, CUDA tensors launch the kernel, anything else raises.
``window_gather_matmul_bs.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nerf_downstream_tpu_torch.ops.kernels import build, tc
from nerf_downstream_tpu_torch.ops.kernels.gather_matmul import (
    window_gather_matmul_plain,
)

_DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 32  # input channels per step of the tensor-core core
MAX_C = 32 * CHUNK  # one bit per chunk in a 32-bit mask
_P, _I = ctypes.c_void_p, ctypes.c_int
# feats, n_rows, c, starts, idx, w, live, nbi, nbo, block, groups,
# n_tiles, members, tile, cout, out, bf16, bn, parts, per, part, stream
_ARGTYPES = (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _P, _I, _I, _I, _I, _P, _P)


def live_mask(live: torch.Tensor, block: int, c: int,
              cout: int) -> torch.Tensor:
    """The liveness [..., nbi, nbo] expanded to a bool [..., C, Cout] mask
    of the weights (edge blocks clamped)."""
    return (live.bool().repeat_interleave(block, -2)
            .repeat_interleave(block, -1)[..., :c, :cout])


def live_step_share(live: torch.Tensor, block: int, c: int, cout: int,
                    column_tile: int) -> float:
    """Share of the (term, 32-channel chunk, column tile) steps of the
    tensor-core core that have a live block under them, for the spec
    ``live`` [G, M, nbi, nbo] alone (the plan's absent rows aside): the
    work K5 does against K2's on the same weights."""
    mask = live_mask(live, block, c, cout).flatten(0, -3).double()
    nk, nct = -(-c // CHUNK), -(-cout // column_tile)
    mask = F.pad(mask, (0, nct * column_tile - cout, 0, nk * CHUNK - c))
    steps = mask.reshape(-1, nk, CHUNK, nct, column_tile).amax((2, 4))
    return float(steps.mean())


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

    ``feats`` [N_rows, C] (float32 or bfloat16; C <= ``MAX_C`` in
    bfloat16); ``starts`` int32[G, nT]; ``idx`` int32[G, nT, M, T] (-1 =
    absent); ``w`` [G, M, C, Cout] in the type of ``feats``; ``live``
    uint8[G, M, ceil(C / block), ceil(Cout / block)], nonzero = live.
    ``masked``: ``w`` is already zero on every dead block (a caller that
    keeps its weights so between calls); otherwise the wrapper zeroes them
    first, one elementwise pass.
    """
    dev = feats.device
    if dev.type == "cpu":
        return window_gather_matmul_bs_plain(feats, starts, idx, w, live,
                                             block)
    if dev.type != "cuda":
        raise ValueError(f"window_gather_matmul_bs: unsupported device {dev}")
    return _launch(feats, starts, idx, w, live, block, masked)


def _launch(feats, starts, idx, w, live, block: int, masked: bool):
    """Checks, the launch choice, and one launch of the kernel."""
    dev = feats.device
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
    n_out = nt * tile
    choice = tc.gather_choice(feats.dtype, n_out, c, cout, g_count * m)
    if choice.core == "tensor":
        if c > MAX_C:
            raise ValueError(f"window_gather_matmul_bs: C = {c} > {MAX_C} "
                             "in bfloat16")
        if tc.vector_ok(c, cout):
            tc.check_aligned("window_gather_matmul_bs", feats, w)
    out = torch.empty((n_out, cout), dtype=feats.dtype, device=dev)
    part = (torch.empty(choice.scratch_numel(n_out, cout),
                        dtype=torch.float32, device=dev)
            if choice.parts > 1 else None)
    fn = build.function("window_gather_matmul_bs",
                        "window_gather_matmul_bs_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            feats.data_ptr(), n_rows, c, starts.data_ptr(), idx.data_ptr(),
            w.data_ptr(), live.data_ptr(), nbi, nbo, block, g_count, nt,
            m, tile, cout, out.data_ptr(), int(choice.core == "tensor"),
            choice.column_tile, choice.parts, choice.per,
            None if part is None else part.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"window_gather_matmul_bs launch failed: CUDA error {err}"
        )
    window_gather_matmul_bs.launches += 1
    return out


window_gather_matmul_bs.launches = 0
