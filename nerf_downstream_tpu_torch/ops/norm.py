"""Masked normalization statistics for padded sparse rows (counterpart of
``nerf_downstream_tpu/ops/norm.py``)."""

from __future__ import annotations

import torch


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
