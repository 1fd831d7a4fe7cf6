"""Layers over SparseVoxels: windowed conv, conv-transpose, BN, activations
(counterpart of ``nerf_downstream_tpu/models/mink/layers.py``, the
fully-windowed path, forward and backward).

Every k3/s1 conv and k2/s2 down conv rides window plans built from the
level's sorted keys; the k2 transpose conv reuses the down conv's plans
(the cache returns them). 1x1 stride-1 convs are plain matrix products, as
the reference leaves them to XLA. Conv kernels are stored [K, Cin, Cout]
with x-fastest offsets, the reference's layout. Parameters start at zero
(no hidden random state): weights come from
``convert.load_flax_variables``, or from ``convert.init_flax_variables``
with an explicit seed.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from nerf_downstream_tpu_torch.ops.norm import (
    batch_norm_apply,
    masked_mean_var,
)
from nerf_downstream_tpu_torch.ops.window_conv import window_conv_apply
from nerf_downstream_tpu_torch.sparse import CoordinateContext, kernel_offsets
from nerf_downstream_tpu_torch.sparse.types import SparseVoxels


def as_rows(sv: SparseVoxels) -> SparseVoxels:
    """Row features of a level. The port keeps every level in rows (no
    block-resident layout), so this is the identity."""
    return sv


class SparseConv(nn.Module):
    """Sparse convolution; stride 2 emits the next coarser level.

    ``input_grad=False`` declares that the input is never differentiated
    (first-layer convs over the data batch): no transpose plan is built.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 use_bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 input_grad: bool = True):
        super().__init__()
        if (kernel_size, stride) not in ((1, 1), (3, 1), (2, 2)):
            raise ValueError(
                f"windowed path has no kernel {kernel_size} / stride {stride}"
            )
        self.kernel_size = kernel_size
        self.stride = stride
        self.compute_dtype = compute_dtype
        self.input_grad = input_grad
        k = kernel_size ** 3
        self.kernel = nn.Parameter(torch.zeros(k, in_channels, out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, sv: SparseVoxels, ctx: CoordinateContext):
        cd = self.compute_dtype
        if self.kernel_size == 1 and self.stride == 1:
            # bf16 operands, f32 products and sums (preferred type f32)
            out_f = (sv.masked_feats().to(cd).to(torch.float32)
                     @ self.kernel[0].to(cd).to(torch.float32))
            if self.bias is not None:
                out_f = out_f + self.bias
            return sv.replace(feats=out_f)
        offs = kernel_offsets(self.kernel_size, sv.stride)
        s1 = self.stride == 1
        if s1:
            out_sv = sv
            plan = ctx.window_plan_direct(sv.coords, sv.mask, offs,
                                          stride=sv.stride)
            inv_plan = (
                ctx.window_plan_direct(sv.coords, sv.mask, offs,
                                       transpose=True, stride=sv.stride)
                if self.input_grad else None
            )
        else:
            out_sv = ctx.strided(sv, 2)
            plan = ctx.window_plan_cross(sv, out_sv, offs, expanding=True)
            inv_plan = ctx.window_plan_cross(out_sv, sv, offs, transpose=True)
        out_f = window_conv_apply(
            sv.feats, plan, inv_plan, self.kernel, self.bias,
            compute_dtype=cd, input_grad=self.input_grad or not s1,
        ).to(cd)
        out_f = ctx.level_poison(out_sv.coords, out_f)
        return SparseVoxels(coords=out_sv.coords, feats=out_f,
                            mask=out_sv.mask, stride=out_sv.stride)


class SparseConvTranspose(nn.Module):
    """k2/s2 transposed conv onto the cached finer level ``target``: its
    plan is the transpose of the encoder down conv's, and its inverse plan
    is that down conv's own plan."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.zeros(8, in_channels, out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, sv: SparseVoxels, ctx: CoordinateContext,
                target: SparseVoxels):
        offs = kernel_offsets(2, target.stride)
        plan = ctx.window_plan_cross(sv, target, offs, transpose=True)
        inv_plan = ctx.window_plan_cross(target, sv, offs, expanding=True)
        out_f = window_conv_apply(
            sv.feats, plan, inv_plan, self.kernel, self.bias,
            compute_dtype=self.compute_dtype,
        ).to(self.compute_dtype)
        out_f = ctx.level_poison(target.coords, out_f)
        return SparseVoxels(coords=target.coords, feats=out_f,
                            mask=target.mask, stride=target.stride)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows with running statistics.

    Train mode (``module.train()``) normalizes with the masked, biased
    batch statistics (the gradient flows through them) and updates the
    running mean and the running *unbiased* variance ``var * cnt /
    max(cnt - 1, 1)`` with ``momentum`` as the weight of the new batch
    (torch's convention). Eval mode normalizes with the running statistics.
    """

    def __init__(self, num_channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("running_mean", torch.zeros(num_channels))
        self.register_buffer("running_var", torch.ones(num_channels))

    def forward(self, sv: SparseVoxels) -> SparseVoxels:
        if self.training:
            mean, var, cnt = masked_mean_var(sv.feats, sv.mask,
                                             return_count=True)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (cnt / torch.clamp(cnt - 1.0, min=1.0))
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        return sv.replace(feats=batch_norm_apply(
            sv.feats, mean, var, self.weight, self.bias, self.eps,
        ))


NONLINEARITIES = {
    "ReLU": F.relu,
    "MinkowskiReLU": F.relu,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "MinkowskiLeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "ELU": F.elu,
    "MinkowskiELU": F.elu,
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "MinkowskiGELU": lambda x: F.gelu(x, approximate="tanh"),
    "SiLU": F.silu,
    "MinkowskiSiLU": F.silu,
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
}


def get_nonlinearity(name: str):
    """Activation on a level's features, by the reference's names."""
    if name not in NONLINEARITIES:
        raise ValueError(f"unknown nonlinearity {name!r}")
    fn = NONLINEARITIES[name]

    def apply(sv: SparseVoxels) -> SparseVoxels:
        return sv.replace(feats=fn(sv.feats))

    return apply


def make_norm(norm_type: str, num_channels: int, *,
              bn_momentum: float = 0.1) -> nn.Module:
    """Norm factory; the port has BatchNorm ("BN") only."""
    if norm_type == "BN":
        return MaskedBatchNorm(num_channels, momentum=bn_momentum)
    raise ValueError(f"norm type {norm_type!r} is not ported")


def cat(a: SparseVoxels, b: SparseVoxels) -> SparseVoxels:
    """Feature concat of two levels on the same coordinate set (UNet skip),
    promoting to the wider type as the reference does."""
    dt = torch.promote_types(a.feats.dtype, b.feats.dtype)
    return a.replace(feats=torch.cat([a.feats.to(dt), b.feats.to(dt)], -1))
