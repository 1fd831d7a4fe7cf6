"""Masked normalization statistics for padded sparse rows (counterpart of
``nerf_downstream_tpu/ops/norm.py``)."""

from __future__ import annotations

import torch

from nerf_downstream_tpu_torch.ops.scatter import add_rows, gather_rows


def masked_mean_var(feats: torch.Tensor, mask: torch.Tensor,
                    return_count: bool = False):
    """Per-channel mean and (biased) variance over the valid rows of
    ``feats`` [..., C]; with ``return_count`` also the valid-row count."""
    m = mask.to(torch.float32)[..., None]
    f = feats.to(torch.float32)
    axes = tuple(range(f.ndim - 1))
    cnt = torch.clamp(m.sum(), min=1.0)
    mean = (f * m).sum(axes) / cnt
    var = torch.clamp((f * f * m).sum(axes) / cnt - mean * mean, min=0.0)
    if return_count:
        return mean, var, cnt
    return mean, var


def batch_norm_apply(feats, mean, var, scale, bias, eps=1e-5):
    """(feats - mean) / sqrt(var + eps) * scale + bias, computed in f32 and
    returned in the type of ``feats``."""
    inv = torch.rsqrt(var + eps)
    out = (feats.to(torch.float32) - mean) * inv
    return (out * scale + bias).to(feats.dtype)


def layer_norm(feats, scale, bias, eps=1e-5):
    """Per-row LayerNorm over the channels (the reference's
    MinkowskiLayerNorm), statistics in f32, output in the type of
    ``feats``."""
    f = feats.to(torch.float32)
    mean = f.mean(-1, keepdim=True)
    var = ((f - mean) ** 2).mean(-1, keepdim=True)
    out = (f - mean) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(feats.dtype)


def instance_norm_stats(feats: torch.Tensor, batch_ids: torch.Tensor,
                        num_batches: int):
    """Per-(scene, channel) mean and (biased, clamped at 0) variance of
    ``feats`` [N, C] in f32, broadcast back to the rows. ``batch_ids``
    puts padding rows in the spare segment ``num_batches``, so they count
    in no scene's statistics. The segment sums accumulate with
    ``add_rows`` (a fixed order, as ``ops/pool.py``'s)."""
    f = feats.to(torch.float32)
    ids = batch_ids.long()
    ns = num_batches + 1
    cnt = add_rows(f.new_zeros(ns), ids, f.new_ones(f.shape[0]))
    s1 = add_rows(f.new_zeros(ns, f.shape[1]), ids, f)
    s2 = add_rows(f.new_zeros(ns, f.shape[1]), ids, f * f)
    cnt = torch.clamp(cnt, min=1.0)[:, None]
    mean = s1 / cnt
    var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
    return gather_rows(mean, ids), gather_rows(var, ids)
