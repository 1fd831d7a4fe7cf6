"""K6 ``row_gather_matmul``: the forward of a sparse conv over a row
kernel map.

Replaces the Pallas TPU kernel ``gather_matmul``
(``nerf_downstream_tpu/ops/pallas/gather_matmul.py:76``). The CUDA kernel
is ``row_gather_matmul.cu`` (its header states the bound on the H100 and
the design): bfloat16 inputs run on the tensor cores with the column tile
and (term, channel chunk) step split of ``tc.row_choice``, float32 ones on
the CUDA cores; the output is float32 either way.
``row_gather_matmul_plain`` is the same function in plain PyTorch,
written from the reference's ``gather_matmul_reference``.

The wrapper dispatches on the device of its tensors: CPU tensors take the
plain version, CUDA tensors launch the kernel, anything else raises.
``row_gather_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_downstream_tpu_torch.ops.kernels import build, tc

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# x_ext, n_in, c, km, k, n_out, w, cout, out, bf16, bn, vec, parts, per,
# part, stream
_ARGTYPES = (_P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P,
             _P)


def row_gather_matmul_plain(x_ext, km, w):
    """Plain PyTorch K6: per offset k, gather rows ``km[k]`` of ``x_ext``
    (whose last row is zero), multiply by ``w[k]`` and accumulate, all in
    f32."""
    acc = torch.zeros((km.shape[1], w.shape[-1]), dtype=torch.float32,
                      device=x_ext.device)
    for k in range(km.shape[0]):
        acc += x_ext[km[k].long()].float() @ w[k].float()
    return acc


def row_gather_matmul(x_ext, km, w):
    """out [N_out, Cout] f32 = sum_k x_ext[km[k, n]] @ w[k].

    ``x_ext`` [N_in + 1, Cin] (float32 or bfloat16; row N_in is the zero
    row); ``km`` int32[K, N_out], entries in [0, N_in], N_in = no
    neighbour; ``w`` [K, Cin, Cout] in the type of ``x_ext``.
    """
    dev = x_ext.device
    if dev.type == "cpu":
        return row_gather_matmul_plain(x_ext, km, w)
    if dev.type != "cuda":
        raise ValueError(f"row_gather_matmul: unsupported device {dev}")
    return _launch(x_ext, km, w)


def _launch(x_ext, km, w):
    """Checks, the launch choice, and one launch of the kernel."""
    dev = x_ext.device
    n_ext, c = x_ext.shape
    k, n_out = km.shape
    cout = w.shape[-1]
    if x_ext.dtype not in _DTYPES:
        raise TypeError(f"row_gather_matmul: x_ext {x_ext.dtype} "
                        "unsupported (float32 or bfloat16)")
    build.check_inputs(dev, (
        (x_ext, "x_ext", x_ext.dtype, (n_ext, c)),
        (km, "km", torch.int32, (k, n_out)),
        (w, "w", x_ext.dtype, (k, c, cout)),
    ))
    choice = tc.row_choice(x_ext.dtype, n_out, c, cout, k,
                           tc.aligned(x_ext, w))
    out = torch.empty((n_out, cout), dtype=torch.float32, device=dev)
    part = (torch.empty(choice.scratch_numel(n_out, cout),
                        dtype=torch.float32, device=dev)
            if choice.parts > 1 else None)
    fn = build.function("row_gather_matmul", "row_gather_matmul_launch",
                        _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_ext.data_ptr(), n_ext - 1, c, km.data_ptr(), k, n_out,
                 w.data_ptr(), cout, out.data_ptr(),
                 int(choice.core == "tensor"), choice.column_tile,
                 int(choice.vec), choice.parts, choice.per,
                 None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"row_gather_matmul launch failed: CUDA error {err}")
    row_gather_matmul.launches += 1
    return out


row_gather_matmul.launches = 0
