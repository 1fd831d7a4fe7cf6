"""PowerNorm for sparse voxel rows (counterpart of
``nerf_downstream_tpu/models/mink/powernorm.py``; the reference's
co3d_3d/src/models/mink/modules/powernorm.py:24-329).

Normalization by the running second moment instead of batch mean/var:
- ``group_scaling``: per-row, per-group second-moment scaling (:24-49);
- forward: z = x / sqrt(phi + eps), where phi is the batch mean-square
  during the first ``warmup_iters`` steps and the running one after, and
  in eval mode the running one;
- ``running_phi`` EMA with ``alpha_fwd``, averaged over the warm-up.

The backward (``_PowerFunction``, the reference's PowerFunction.backward,
:99-139) applies an EMA correction, g' = gy * weight - (1 - abkw) *
ema_gz * z, divides by the *batch* second moment (even after the
warm-up, when the forward divided by the running one), sends no gradient
into the statistics, and advances the ``ema_gz`` buffer in place during
the backward pass. Every mean and sum runs over the valid rows only.

``convert_powernorm_state`` is the BN -> PN state transform (:291-329);
``convert_powernorm_tree`` applies it to every BatchNorm of a checkpoint's
variable trees.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.ops.block_resident import remask
from nerf_downstream_tpu_torch.sparse.types import SparseVoxels

_ABKW = 0.9  # alpha_bkw; the reference never overrides the default


class _PowerFunction(torch.autograd.Function):
    """y = weight * x / sqrt(denom + eps) + bias with the reference's
    EMA-corrected backward; ``ema_gz`` (the module's buffer) gains
    sum_valid(g' * z) / count when the backward runs."""

    @staticmethod
    def forward(ctx, x, weight, bias, denom, var_batch, mask_f, ema_gz,
                eps):
        z = x * torch.rsqrt(denom + eps)
        ctx.save_for_backward(z, var_batch, weight, mask_f)
        ctx.ema_gz = ema_gz
        ctx.eps = eps
        return weight * z + bias

    @staticmethod
    def backward(ctx, gy):
        z, var_batch, weight, mask_f = ctx.saved_tensors
        ema = ctx.ema_gz
        m = mask_f[:, None]
        cnt = torch.clamp(mask_f.sum(), min=1.0)
        approx = gy * weight - (1.0 - _ABKW) * ema * z
        delta = (approx * z * m).sum(0)
        d_x = approx * torch.rsqrt(var_batch + ctx.eps) * m
        d_weight = (gy * z * m).sum(0)
        d_bias = (gy * m).sum(0)
        with torch.no_grad():
            ema.copy_(ema + delta / cnt)
        return d_x, d_weight, d_bias, None, None, None, None, None


def group_scaling(feats: torch.Tensor, group_num: int, eps: float = 1e-5):
    """Each row's channels, in ``group_num`` groups, divided by the
    group's root mean square."""
    n, c = feats.shape
    cg = max(c // group_num, 1)
    g = feats.reshape(n, -1, cg)
    moment2 = (g * g).mean(2, keepdim=True)
    return (g / torch.sqrt(moment2 + eps)).reshape(n, c)


@cfg.configurable
class MinkPowerNorm(nn.Module):
    """PowerNorm over the valid rows of a level. Buffers: ``running_phi``
    (f32 [C], ones), ``iters`` (int32 scalar, the train steps taken) and
    ``ema_gz`` (f32 [C], zeros). Train mode (``module.train()``) advances
    ``running_phi`` and ``iters`` in the forward and ``ema_gz`` in the
    backward; eval mode divides by ``running_phi``."""

    flax_name = "MinkPowerNorm"

    def __init__(self, num_channels: int, eps: float = 1e-5,
                 alpha_fwd: float = 0.9, warmup_iters: int = 10000,
                 group_num: int = 1):
        super().__init__()
        self.eps = eps
        self.alpha_fwd = alpha_fwd
        self.warmup_iters = warmup_iters
        self.group_num = group_num
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("running_phi", torch.ones(num_channels))
        self.register_buffer("iters", torch.zeros((), dtype=torch.int32))
        self.register_buffer("ema_gz", torch.zeros(num_channels))

    def forward(self, sv: SparseVoxels) -> SparseVoxels:
        c = sv.num_channels
        # rows, or a resident level's cells flattened
        x = group_scaling(sv.feats.reshape(-1, c).to(torch.float32),
                          self.group_num, self.eps)
        if not self.training:
            z = x / torch.sqrt(self.running_phi + self.eps)
            return self._out(sv, self.weight * z + self.bias)
        mask_f = sv.mask.reshape(-1).to(torch.float32)
        cnt = torch.clamp(mask_f.sum(), min=1.0)
        x2 = ((x * x).detach() * mask_f[:, None]).sum(0) / cnt
        it = self.iters + 1
        phi = self.running_phi
        denom = torch.where(it <= self.warmup_iters, x2, phi)
        out = _PowerFunction.apply(x, self.weight, self.bias, denom, x2,
                                   mask_f, self.ema_gz, self.eps)
        with torch.no_grad():
            warm_phi = phi * (it - 1) / it + x2 / it
            new_phi = torch.where(it < self.warmup_iters, warm_phi, phi)
            self.running_phi.copy_(self.alpha_fwd * new_phi
                                   + (1 - self.alpha_fwd) * x2)
            self.iters.copy_(it)
        return self._out(sv, out)

    @staticmethod
    def _out(sv, out):
        """``out`` [rows, C] back in ``sv``'s shape and type, unoccupied
        cells of a resident level zero."""
        out = out.to(sv.feats.dtype).reshape(sv.feats.shape)
        return sv.replace(feats=remask(sv, out))


def convert_powernorm_state(bn_params: dict, bn_stats: dict):
    """BN -> PN state transform: scale and bias carry over; running_phi
    starts from the BN running variance, iters from 0 and ema_gz from
    zeros (the reference's convert_powernorm, :291-329)."""
    params = dict(bn_params)
    var = np.asarray(bn_stats.get("var"), np.float32)
    stats = {"running_phi": var, "iters": np.zeros((), np.int32),
             "ema_gz": np.zeros_like(var)}
    return params, stats


def convert_powernorm_tree(params: dict, batch_stats: dict):
    """(params, batch_stats) of a checkpoint with every BatchNorm whose
    statistics hold ``mean`` and ``var`` turned into a PowerNorm of the
    same place (``MaskedBatchNorm_<i>`` -> ``MinkPowerNorm_<i>``, state by
    ``convert_powernorm_state``); other leaves as they are."""
    bn, pn = "MaskedBatchNorm_", MinkPowerNorm.flax_name + "_"

    def walk(p, s):
        p_out, s_out = {}, {}
        for k in sorted(set(p) | set(s)):
            pv, sv = p.get(k), s.get(k)
            if (k.startswith(bn) and isinstance(sv, dict)
                    and "mean" in sv and "var" in sv):
                name = pn + k[len(bn):]
                p_out[name], s_out[name] = convert_powernorm_state(
                    pv or {}, sv)
                continue
            if isinstance(pv, dict) or isinstance(sv, dict):
                sub_p, sub_s = walk(pv or {}, sv or {})
                if pv is not None:
                    p_out[k] = sub_p
                if sv is not None:
                    s_out[k] = sub_s
                continue
            if pv is not None:
                p_out[k] = pv
            if sv is not None:
                s_out[k] = sv
        return p_out, s_out

    return walk(params, batch_stats)
