"""PAConv's assign-score ops (counterpart of
``nerf_downstream_tpu/ops/paconv.py``):

    out[b, n, o] = sum_{k, m} scores[b, n, k, m] *
                   (points[b, knn[b, n, k], m, o] - centers[b, n, m, o])

The reference computes this with XLA (a scan over k with a custom VJP),
not with a Pallas kernel, so the port computes it in plain PyTorch, in the
same shape: the forward loops over k (gather, product, accumulate) so that
only one [B, N, M, O] slab is live, and the backward
(``_AssignScore.backward``) recomputes the gathers for d_scores, adds
d_points over the kNN rows with ``ops/scatter.add_rows_`` (each row's
terms in a fixed order on the card and on the CPU, so a training step
repeats bit for bit) and takes d_centers as
``-sum_k scores (x) g``. ``assign_score_withk_reference`` is the naive
version (it materialises [B, N, K, M, O]) that the tests hold the others
to.
"""

from __future__ import annotations

import torch

from nerf_downstream_tpu_torch.ops.scatter import add_rows_, gather_rows


def _rows(knn_k: torch.Tensor, n_points: int) -> torch.Tensor:
    """Flat row indices [B * N] into a [B * Np, ...] table of the kNN
    slot ``knn_k`` [B, N]."""
    b = knn_k.shape[0]
    base = torch.arange(b, device=knn_k.device)[:, None] * n_points
    return (knn_k.long() + base).reshape(-1)


def _gather(flat_points: torch.Tensor, rows: torch.Tensor, b: int, n: int):
    """[B, N, M, O] rows of ``flat_points`` [B * Np, M, O]."""
    return gather_rows(flat_points, rows).reshape(b, n,
                                                  *flat_points.shape[1:])


class _AssignScore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, points, centers, knn_idx):
        b, n, k, m = scores.shape
        n_points, o = points.shape[1], points.shape[-1]
        flat = points.reshape(b * n_points, m, o)
        acc = scores.new_zeros((b, n, o), dtype=torch.float32)
        for kk in range(k):
            g = _gather(flat, _rows(knn_idx[:, :, kk], n_points), b, n)
            if centers is not None:
                g = g - centers
            # [B*N, 1, M] @ [B*N, M, O]
            acc = acc + torch.bmm(
                scores[:, :, kk, :].reshape(b * n, 1, m).float(),
                g.reshape(b * n, m, o).float()).reshape(b, n, o)
        ctx.save_for_backward(scores, points, centers, knn_idx)
        return acc.to(points.dtype)

    @staticmethod
    def backward(ctx, g_out):
        scores, points, centers, knn_idx = ctx.saved_tensors
        b, n, k, m = scores.shape
        n_points, o = points.shape[1], points.shape[-1]
        flat = points.reshape(b * n_points, m, o)
        gf = g_out.float().reshape(b * n, o, 1)
        d_scores = torch.zeros(scores.shape, dtype=torch.float32,
                               device=scores.device)
        d_points = torch.zeros((b * n_points, m, o), dtype=torch.float32,
                               device=points.device)
        for kk in range(k):
            rows = _rows(knn_idx[:, :, kk], n_points)
            diff = _gather(flat, rows, b, n).float()
            if centers is not None:
                diff = diff - centers.float()
            d_scores[:, :, kk, :] = torch.bmm(
                diff.reshape(b * n, m, o), gf).reshape(b, n, m)
            contrib = (scores[:, :, kk, :].float().reshape(b * n, m, 1)
                       * gf.reshape(b * n, 1, o))
            add_rows_(d_points, rows, contrib)
        d_centers = None
        if centers is not None:
            s_sum = scores.float().sum(2).reshape(b * n, m, 1)
            d_centers = -(s_sum * gf.reshape(b * n, 1, o)).reshape(
                b, n, m, o).to(centers.dtype)
        return (d_scores.to(scores.dtype),
                d_points.reshape(points.shape).to(points.dtype), d_centers,
                None)


def assign_score_withk(scores, points, centers, knn_idx, aggregate="sum"):
    """The full kernel: ``scores`` [B, N, K, M], ``points`` [B, Np, M, O],
    ``centers`` [B, N, M, O], ``knn_idx`` int [B, N, K] -> [B, N, O]."""
    assert aggregate == "sum"
    return _AssignScore.apply(scores, points, centers, knn_idx)


def assign_score_withk_halfkernel(scores, points, knn_idx, aggregate="sum"):
    """The halfkernel variant: no centers."""
    assert aggregate == "sum"
    return _AssignScore.apply(scores, points, None, knn_idx)


def assign_score_withk_reference(scores, points, centers, knn_idx):
    """The naive version: every neighbour's [M, O] slab at once."""
    b, n, k = knn_idx.shape
    m, o = points.shape[2], points.shape[3]
    flat = points.reshape(b * points.shape[1], m, o)
    g = _gather(flat, _rows(knn_idx.reshape(b, n * k), points.shape[1]),
                b, n * k).reshape(b, n, k, m, o)
    if centers is not None:
        g = g - centers[:, :, None]
    return torch.einsum("bnkm,bnkmo->bno", scores, g)
