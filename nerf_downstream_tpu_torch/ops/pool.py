"""Sparse poolings: window pooling over a row kernel map and global
pooling over the batch (counterpart of ``nerf_downstream_tpu/ops/pool.py``).

The reference computes both with XLA ops (a scan over the map's offsets,
``segment_sum`` / ``segment_max``), not with a Pallas kernel, so the port
computes them in plain PyTorch: gathers and accumulating scatters
through ``ops/scatter.py`` (each adds a row's terms in a fixed order, on
the card and on the CPU, so a training step repeats) and
``scatter_reduce``.
The global max's backward is written out (``_SegmentMax``): each row
equal to its element's maximum takes the gradient divided by the count
of such rows, the reference's rule for ties, with the count added by
``add_rows``.
"""

from __future__ import annotations

import torch

from nerf_downstream_tpu_torch.ops.scatter import add_rows, gather_rows


def window_pool(feats: torch.Tensor, kernel_map: torch.Tensor,
                mode: str = "avg") -> torch.Tensor:
    """Pool over kernel-map neighbours: [N_out, C] for ``mode`` sum, avg or
    max. ``kernel_map`` int32[K, N_out] names input rows, N_in = no
    neighbour (ignored); avg divides by the count of present neighbours;
    the max of an empty window is 0.

    A missing neighbour reads row ``o mod N_in`` and is masked out: the
    backward of the gathers (a sorting accumulation, one index's rows
    after another) then adds its zeros to rows of their own, where a
    shared zero row would take every missing entry of the map in turn."""
    n_in, c = feats.shape
    n_out = kernel_map.shape[1]
    found = kernel_map < n_in
    spread = torch.arange(n_out, device=feats.device) % n_in

    def gather(k):
        return gather_rows(feats, torch.where(found[k], kernel_map[k].long(),
                                              spread))

    if mode == "max":
        neg = torch.finfo(feats.dtype).min
        acc = feats.new_full((n_out, c), neg)
        for k in range(kernel_map.shape[0]):
            acc = torch.maximum(acc, torch.where(found[k][:, None],
                                                 gather(k), neg))
        return torch.where(acc == neg, 0, acc)
    acc = feats.new_zeros((n_out, c))
    cnt = feats.new_zeros((n_out,))
    for k in range(kernel_map.shape[0]):
        acc = acc + torch.where(found[k][:, None], gather(k), 0)
        cnt = cnt + found[k].to(feats.dtype)
    if mode == "sum":
        return acc
    if mode == "avg":
        return acc / torch.clamp(cnt, min=1)[:, None]
    raise ValueError(f"unknown pool mode {mode!r}")


class _SegmentMax(torch.autograd.Function):
    """Per-segment maximum [num_segments, C] of ``feats`` [N, C] over
    ``ids`` (-inf where a segment has no rows)."""

    @staticmethod
    def forward(ctx, feats, ids, num_segments: int):
        c = feats.shape[1]
        out = feats.new_full((num_segments, c), float("-inf"))
        out = out.scatter_reduce(0, ids[:, None].expand(-1, c), feats,
                                 "amax", include_self=True)
        ctx.save_for_backward(feats, ids, out)
        return out

    @staticmethod
    def backward(ctx, g):
        feats, ids, out = ctx.saved_tensors
        hit = (feats == out[ids]).to(g.dtype)
        ties = add_rows(torch.zeros_like(g), ids, hit)
        return hit * (g / torch.clamp(ties, min=1))[ids], None, None


def global_pool(feats: torch.Tensor, batch_ids: torch.Tensor,
                num_batches: int, mode: str = "avg") -> torch.Tensor:
    """Pooling of each batch element's rows to [num_batches, C] (avg, max
    or sum). ``batch_ids`` maps padding rows to ``num_batches``
    (``SparseVoxels.batch_ids``); an element with no rows pools to 0."""
    c = feats.shape[1]
    ids = batch_ids.long()
    if mode == "max":
        out = _SegmentMax.apply(feats, ids, num_batches + 1)[:num_batches]
        return torch.where(torch.isfinite(out), out, 0)
    sums = add_rows(feats.new_zeros((num_batches + 1, c)), ids,
                    feats)[:num_batches]
    if mode == "sum":
        return sums
    if mode == "avg":
        cnt = add_rows(feats.new_zeros((num_batches + 1,)), ids,
                       torch.ones_like(ids, dtype=feats.dtype))[:num_batches]
        return sums / torch.clamp(cnt, min=1)[:, None]
    raise ValueError(f"unknown pool mode {mode!r}")
