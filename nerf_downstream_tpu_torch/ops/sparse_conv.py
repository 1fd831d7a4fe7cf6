"""Sparse convolution over a row kernel map (counterpart of
``nerf_downstream_tpu/ops/sparse_conv.py``).

For each kernel offset k the index table ``kernel_map[k]`` (int32[N_out],
sentinel N_in) selects input rows; a zero sentinel row makes a missing
neighbour add nothing:

    out = sum_k (feats ++ [0])[kernel_map[k]] @ W[k]

in f32. The forward is K6 (``row_gather_matmul``). The backward is a
``torch.autograd.Function`` in plain PyTorch, as the reference computes it
outside any Pallas kernel: d_w[k] is the gathered rows' product with the
output gradient; d_feats is a scatter-add of ``g @ W[k]^T`` onto the
gathered rows, or, given the inverted map, a gather of the output
gradient rows instead; d_feats is skipped when the input needs no
gradient (a stem conv over the data batch). Only the inputs are saved;
the backward gathers again.
"""

from __future__ import annotations

import torch

from nerf_downstream_tpu_torch.ops.kernels import row_gather_matmul
from nerf_downstream_tpu_torch.ops.scatter import add_rows_, gather_rows


def _d_w(feats_ext, kernel_map, gc):
    """d_w[k] = feats_ext[km[k]]^T @ g, f32."""
    return torch.stack([
        feats_ext[kernel_map[k].long()].float().t() @ gc.float()
        for k in range(kernel_map.shape[0])
    ])


class _SparseConvCore(torch.autograd.Function):
    """K6 forward; backward by scatter-adds (the reference's ``_core_bwd``)
    through ``add_rows_``, which adds each row's terms in a fixed order."""

    @staticmethod
    def forward(ctx, feats_ext, kernel_map, w):
        ctx.save_for_backward(feats_ext, kernel_map, w)
        return row_gather_matmul(feats_ext, kernel_map, w)

    @staticmethod
    def backward(ctx, g):
        feats_ext, kernel_map, w = ctx.saved_tensors
        gc = g.to(w.dtype)
        d_feats = None
        if ctx.needs_input_grad[0]:
            d_feats = torch.zeros(feats_ext.shape, dtype=torch.float32,
                                  device=g.device)
            for k in range(kernel_map.shape[0]):
                contrib = gc.float() @ w[k].float().t()
                add_rows_(d_feats, kernel_map[k], contrib)
            d_feats[-1] = 0.0  # the sentinel row has no gradient
            d_feats = d_feats.to(feats_ext.dtype)
        return d_feats, None, _d_w(feats_ext, kernel_map, gc).to(w.dtype)


class _SparseConvCoreInv(torch.autograd.Function):
    """K6 forward; d_feats by gathers through the inverted map
    (``inv_map[k, i]`` = the output row whose offset-k neighbour is input
    row i, sentinel N_out; the reference's ``_core_inv_bwd``)."""

    @staticmethod
    def forward(ctx, feats_ext, kernel_map, inv_map, w):
        ctx.save_for_backward(feats_ext, kernel_map, inv_map, w)
        return row_gather_matmul(feats_ext, kernel_map, w)

    @staticmethod
    def backward(ctx, g):
        feats_ext, kernel_map, inv_map, w = ctx.saved_tensors
        gc = g.to(w.dtype)
        d_feats = None
        if ctx.needs_input_grad[0]:
            g_ext = torch.cat([gc, gc.new_zeros((1, gc.shape[1]))])
            d_in = torch.zeros((inv_map.shape[1], feats_ext.shape[1]),
                               dtype=torch.float32, device=g.device)
            for k in range(inv_map.shape[0]):
                d_in += g_ext[inv_map[k].long()].float() @ w[k].float().t()
            d_feats = torch.zeros(feats_ext.shape, dtype=torch.float32,
                                  device=g.device)
            d_feats[:inv_map.shape[1]] = d_in
            d_feats[-1] = 0.0
            d_feats = d_feats.to(feats_ext.dtype)
        return (d_feats, None, None,
                _d_w(feats_ext, kernel_map, gc).to(w.dtype))


def sparse_conv_apply(feats: torch.Tensor, kernel_map: torch.Tensor,
                      weights: torch.Tensor, bias: torch.Tensor | None = None,
                      compute_dtype: torch.dtype = torch.float32,
                      inv_map: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse conv given a kernel map: [N_out, Cout] f32.

    ``feats`` [N_in, Cin] (padding rows are never referenced);
    ``kernel_map`` int32[K, N_out], N_in = no neighbour; ``weights``
    [K, Cin, Cout]; ``compute_dtype`` is the type of the gathered operand
    and the weights (sums stay f32). ``inv_map`` (the transpose map) makes
    the backward's d_feats a gather instead of a scatter-add.
    """
    cin = feats.shape[1]
    feats_ext = torch.cat([feats, feats.new_zeros((1, cin))]).to(
        compute_dtype).contiguous()
    w = weights.to(compute_dtype).contiguous()
    if kernel_map.shape[0] == 1:
        # kernel volume 1: a plain gather and matmul
        out = gather_rows(feats_ext, kernel_map[0]).float() @ w[0].float()
    elif inv_map is not None:
        out = _SparseConvCoreInv.apply(feats_ext, kernel_map.contiguous(),
                                       inv_map, w)
    else:
        out = _SparseConvCore.apply(feats_ext, kernel_map.contiguous(), w)
    if bias is not None:
        out = out + bias.float()
    return out
