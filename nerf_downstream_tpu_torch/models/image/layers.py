"""Layers of the 2D models with flax's semantics (the JAX package builds
them from ``flax.linen``).

- ``Conv2d``: kernel ``[Cout, Cin / groups, kh, kw]`` (the one layout
  that differs from flax's HWIO; ``convert.py`` transposes it), inputs,
  kernel and bias cast to the compute ``dtype``, as ``nn.Conv(dtype=)``.
- ``Dense``: flax's ``DenseGeneral`` layout, kernel ``[*in_shape,
  *out_shape]`` and bias ``out_shape`` (a plain dense layer is
  ``Dense((C,), (Cout,))``), computed in ``dtype``.
- ``BatchNorm``: flax's ``nn.BatchNorm(momentum=0.9)`` (also the dense
  heads' of ``models/mink/fcnn.py``): statistics in at
  least f32 whatever the compute type, the running variance updated with the
  *biased* batch variance (``nn.BatchNorm2d`` uses the unbiased one),
  epsilon 1e-5, the output in ``dtype``.
- ``LayerNorm``: flax's ``nn.LayerNorm``: epsilon 1e-6 (torch's default
  is 1e-5), statistics in at least f32, the output in ``dtype``.

Every layer draws its initial values in ``reset_parameters(gen)`` with
flax's distributions (``init_weights``).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled to variance 1 / fan-in
_TRUNC_STD = 0.87962566103423978


def at_least_f32(x):
    """``x`` in the wider of its type and f32 (flax's promotion for norm
    statistics)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    w = torch.empty(t.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
    with torch.no_grad():
        t.copy_(w)


class Conv2d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, gen):
        fan_in = self.kernel.shape[1] * self.kernel.shape[2] \
            * self.kernel.shape[3]
        lecun_normal_(self.kernel, fan_in, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype), bias,
                        self.stride, self.padding, 1, self.groups)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` over the last ``len(in_shape)`` axes of
    ``x``, giving ``out_shape`` (flax's ``DenseGeneral``)."""

    def __init__(self, in_shape, out_shape, dtype=torch.float32):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*self.in_shape,
                                               *self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def reset_parameters(self, gen):
        lecun_normal_(self.kernel, math.prod(self.in_shape), gen)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = x.to(self.dtype).reshape(*lead, n_in) @ \
            self.kernel.to(self.dtype).reshape(n_in, n_out)
        y = y + self.bias.to(self.dtype).reshape(n_out)
        return y.reshape(*lead, *self.out_shape)


class BatchNorm(nn.Module):
    """flax's BatchNorm over the channels (axis 1) of an NCHW or [N, C]
    input: statistics over every other axis, by cuDNN's fused kernels
    (a two-pass variance, where flax computes ``E[x^2] - E[x]^2``;
    ``models/mink/dgcnn.py::BatchNorm`` computes flax's, for the point
    models, whose steps need it). ``zero_scale`` starts the scale at 0
    (the last norm of a residual branch)."""

    def __init__(self, c: int, zero_scale: bool = False, dtype=torch.float32,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.zero_scale, self.dtype = zero_scale, dtype
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        if not self.training:
            y = F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                             False, 0.0, self.eps)
            return y.to(self.dtype)
        y = F.batch_norm(x, None, None, self.scale, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(at_least_f32(x), dim=dims,
                                       unbiased=False)
            m = self.momentum
            self.mean.mul_(m).add_(mean, alpha=1 - m)
            self.var.mul_(m).add_(var, alpha=1 - m)
        return y.to(self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, c: int, dtype=torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        y = F.layer_norm(at_least_f32(x), self.scale.shape, self.scale,
                         self.bias, self.eps)
        return y.to(self.dtype)


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Draw every layer's initial values in place from a ``torch.Generator``
    seeded by ``seed``, with flax's distributions: lecun-normal kernels,
    zero biases, BatchNorm and LayerNorm at identity (a residual branch's
    last BatchNorm scale at 0), and each module's own parameters (the ViT's
    ``cls_token``, ``pos_embed`` and LayerScale) through its
    ``reset_parameters``. The draws match flax's in distribution, not
    value for value."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model
