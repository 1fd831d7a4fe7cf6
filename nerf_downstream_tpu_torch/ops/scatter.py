"""Accumulating scatters and gathers that add in a fixed order on every
device.

On a CUDA tensor an accumulating ``index_put`` sorts its indices and adds
each row's terms one after another, so it repeats bit for bit
(``index_add_`` there adds with atomics, in whatever order they land). On
a CPU tensor it is the other way round: ``index_put(..., accumulate=True)``
splits the work over threads and adds with float atomics, while
``index_add_`` is serial. So each helper dispatches on the tensor's
device. A gather ``x[idx]`` under autograd has an accumulating
``index_put`` as its backward; ``gather_rows`` takes ``index_select`` on
the CPU, whose backward is ``index_add_``.
"""

from __future__ import annotations

import torch


def add_rows_(out: torch.Tensor, index: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``out[index[i]] += values[i]`` along dim 0, in place; returns
    ``out``. ``index`` is 1-D."""
    index = index.long()
    if out.is_cuda:
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values.to(out.dtype))


def add_rows(out: torch.Tensor, index: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """``add_rows_`` out of place (differentiable in ``out`` and
    ``values``)."""
    index = index.long()
    if out.is_cuda:
        return out.index_put((index,), values, accumulate=True)
    return out.index_add(0, index, values.to(out.dtype))


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` for an integer ``index`` of any shape: the rows of
    ``x`` along dim 0, shaped ``index.shape + x.shape[1:]``."""
    index = index.long()
    if x.is_cuda:
        return x[index]
    return torch.index_select(x, 0, index.reshape(-1)).reshape(
        *index.shape, *x.shape[1:])
