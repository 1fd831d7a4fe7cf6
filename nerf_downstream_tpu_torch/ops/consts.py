"""Small constant tensors on a device, made once per value and shared.

Index tables that a conv derives from its static offsets (the plan's
offset order, a weight subset, the negation relabeling, the offsets of a
kernel map) are Python values. Converting one to a CUDA tensor on every
forward is a copy from pageable host memory, which PyTorch completes by
synchronising the stream: the host would wait for the device on every
conv. ``const`` makes each value's tensor once per (value, dtype, device),
copied from pinned memory without blocking, and hands out that tensor
afterwards. Callers never write to it. The tensors are made outside
inference mode, so that training forwards may use them too.
"""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (a nested tuple, list or ndarray of numbers or bools) as
    a ``dtype`` tensor on ``device``, shared by every caller."""
    arr = np.asarray(values)
    device = torch.device(device)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, device)
    hit = _CACHE.get(key)
    if hit is None:
        # a normal tensor even inside inference_mode: a training forward
        # may index with it later, and autograd saves the index
        with torch.inference_mode(False):
            host = torch.tensor(arr, dtype=dtype)  # a copy: callers keep
            if device.type == "cuda":              # theirs
                hit = host.pin_memory().to(device, non_blocking=True)
            else:
                hit = host.to(device)
        _CACHE[key] = hit
    return hit
