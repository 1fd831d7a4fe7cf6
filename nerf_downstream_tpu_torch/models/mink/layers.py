"""Layers over SparseVoxels and block-resident levels (``BlockVoxels``):
conv, conv-transpose, pooling, norms (BN, IN, LN; PowerNorm in
``powernorm.py``), activations (counterpart of
``nerf_downstream_tpu/models/mink/layers.py``: every conv route, forward
and backward, with the weight-sparse inference modes).

Each conv asks the context for its route (``CoordinateContext.
conv_route``). On the fully-windowed path every k3/s1 conv and k2/s2 or
k1/s2 down conv rides window plans built from the level's sorted keys;
the k2 transpose conv reuses the down conv's plans (the cache returns
them). Every other conv (a k3/s2 conv, such as ResNet's strided block
conv; a dilated conv; a strided conv over an offset subset), and every
conv when the context resolves to the row path ("row", "search", or
"auto" without a grid extent), takes the row path, as in the reference:
a row kernel map onto the output level, K6 forward, d_feats through the
inverted map. The other methods, in the reference's order of decisions:
under "block_resident" a level enters dense 4^3 blocks at its first
blockable conv (k3/s1 dense or ZAXIS, k2/s2, k1/s2) and stays there
through norms, activations, adds and k2 poolings and transposes
(``ops/block_resident.py``); under "block" each dense k3/s1 conv runs
through blocks made for it (``ops/block_conv.block_conv3``), its output
NaN-poisoned under ``overflow_guard`` when the blocks overflow their cap
(the reference drops the rows without a block silently); under
"window" a stride-preserving conv with uniform (dx, dy) offset groups
runs K2/K3 on plans from its row kernel map (``ctx.window_plan``), and
strided convs and transposes keep the row path. A consumer of rows
(``as_rows``, ``cat`` of mixed levels) reads a resident level back.
1x1 stride-1 convs are plain matrix products, as the reference leaves
them to XLA. ``SparsePool`` pools over a row kernel map (``ops/pool.py``)
or in-block, and ``GlobalPool`` pools each batch element's rows.
Conv kernels are stored [K, Cin, Cout] with x-fastest offsets, the
reference's layout. Parameters start at zero (no hidden random state):
weights come from ``convert.load_flax_variables``, or from
``convert.init_flax_variables`` with an explicit seed.

Weight-sparse inference (``eval3d --sparsify``), in the reference's order
of decisions: a conv in mode 2 (ZAXIS) runs over its z-column offsets; in
mode 1 over the live offsets ``ctx.valid_offsets_map`` lists under its
module path (``SparseConv.path``). A k3/s1 subset stays windowed, its
(dx, dy) groups padded to one size with zero-weight repeats. A k2/s2 down
conv with a subset leaves the windowed path for the row path (a kernel
map and K6). A windowed conv whose path has an entry in
``ctx.block_live_map`` with at least 25 % dead blocks runs the
block-sparse forward (K5). Each conv records the route it took last in
``route`` (1x1 convs, plain matrix products, record none).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from nerf_downstream_tpu_torch.ops import block_resident as br
from nerf_downstream_tpu_torch.ops.block_conv import block_conv3
from nerf_downstream_tpu_torch.ops.block_resident import BlockVoxels, remask
from nerf_downstream_tpu_torch.ops.consts import const
from nerf_downstream_tpu_torch.ops.norm import (
    batch_norm_apply,
    instance_norm_stats,
    layer_norm,
    masked_mean_var,
)
from nerf_downstream_tpu_torch.ops.pool import global_pool, window_pool
from nerf_downstream_tpu_torch.ops.sparse_conv import sparse_conv_apply
from nerf_downstream_tpu_torch.ops.weight_sparse import (
    pad_offset_groups,
    zaxis_offsets,
)
from nerf_downstream_tpu_torch.ops.window_conv import (
    block_live_tensor,
    group_offsets,
    mask_dead_blocks,
    window_conv_apply,
    window_conv_apply_blocksparse,
)
from nerf_downstream_tpu_torch.sparse import CoordinateContext, kernel_offsets
from nerf_downstream_tpu_torch.sparse.types import SparseVoxels

# least share of dead weight blocks for the block-sparse forward (the
# reference's routing, measured on its TPU; kept for parity)
BLOCK_SPARSE_MIN_DEAD = 0.25


def as_rows(sv):
    """Row features of a level: a resident level read back from its
    cells, rows unchanged (the boundary for row consumers: field slicing,
    interpolation, heads)."""
    if isinstance(sv, BlockVoxels):
        return br.to_rows(sv)
    return sv


def _zaxis_subset(full_offs, subset):
    """A subset of the k3 offsets that is exactly the z column (dx = dy
    = 0, dz = -1, 0, 1 in the level's units) as offset indices in dz
    order, else None: such a subset stays on the block-resident path."""
    if subset is None or len(subset) != 3:
        return None
    sub = full_offs[list(subset)]
    if (sub[:, :2] == 0).all() and sorted(sub[:, 2].tolist()) == [-1, 0, 1]:
        return tuple(int(subset[i]) for i in np.argsort(sub[:, 2]))
    return None


def _window_groups_ok(offs) -> bool:
    """Windowed plans need (dx, dy) offset groups of one size."""
    try:
        group_offsets(offs)
        return True
    except ValueError:
        return False


class SparseConv(nn.Module):
    """Sparse convolution; a stride above 1 emits the coarser level.

    ``dilation`` spaces the kernel's offsets (dilated convs take the row
    path). ``input_grad=False`` declares that the input is never
    differentiated (first-layer convs over the data batch): no windowed
    transpose plan is built.
    ``conv_mode``: 0 dense, 1 the live offsets of a pruned checkpoint
    (``ctx.valid_offsets_map``), 2 ZAXIS (the dx = dy = 0 offsets); a
    static ``valid_offsets`` tuple sets the subset directly. ``path`` is
    the module's name in the reference's variable tree (set by the model
    from ``convert.flax_path``); the sparse maps are keyed by it.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 use_bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 input_grad: bool = True, conv_mode: int = 0,
                 valid_offsets: tuple | None = None, dilation: int = 1):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.compute_dtype = compute_dtype
        self.input_grad = input_grad
        self.conv_mode = conv_mode
        self.valid_offsets = valid_offsets
        self.path = ""
        self.route = None
        # K5's inputs kept between forwards: (key, masked weights, liveness)
        self._bs_cache = (None, None, None)
        k = kernel_size ** 3
        self.kernel = nn.Parameter(torch.zeros(k, in_channels, out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def _subset(self, full_offs, ctx):
        subset = self.valid_offsets
        if self.conv_mode == 2 and subset is None:  # ZAXIS
            subset = zaxis_offsets(full_offs)
        if self.conv_mode == 1 and subset is None and ctx.valid_offsets_map:
            # live offsets of the pruned checkpoint; no entry = dense
            sub = ctx.valid_offsets_map.get(self.path)
            if sub is not None and 0 < len(sub) < len(full_offs):
                subset = tuple(int(i) for i in sub)
        return subset

    def forward(self, sv, ctx: CoordinateContext):
        cd = self.compute_dtype
        if self.kernel_size == 1 and self.stride == 1:
            # bf16 operands, f32 products and sums (preferred type f32)
            feats = (sv.feats if isinstance(sv, BlockVoxels)
                     else sv.masked_feats())
            out_f = (feats.to(cd).to(torch.float32)
                     @ self.kernel[0].to(cd).to(torch.float32))
            if self.bias is not None:
                out_f = remask(sv, out_f + self.bias)
            return sv.replace(feats=out_f)
        full_offs = kernel_offsets(self.kernel_size, sv.stride,
                                   self.dilation)
        subset = self._subset(full_offs, ctx)
        offs = full_offs if subset is None else full_offs[list(subset)]
        s1 = self.kernel_size == 3 and self.stride == 1
        down = (self.kernel_size in (1, 2) and self.stride == 2
                and subset is None)
        if ctx.conv_route(self.dilation == 1 and (s1 or down)) == "row":
            zaxis = _zaxis_subset(full_offs, subset) if s1 else None
            if (ctx.use_block_resident() and self.dilation == 1
                    and (down or s1 and (subset is None
                                         or zaxis is not None))):
                return self._resident_conv(sv, ctx, zaxis)
            sv = as_rows(sv)
            if (s1 and self.dilation == 1 and subset is None
                    and ctx.use_block_conv()):
                return self._block_conv(sv, ctx)
            return self._row_conv(sv, ctx, offs, subset)
        sv = as_rows(sv)
        # a subset with non-uniform (dx, dy) groups is padded with
        # zero-weight repeats of each group's first offset
        w_rows = None
        if subset is not None and not _window_groups_ok(offs):
            offs, w_rows = pad_offset_groups(full_offs, subset)

        if s1:
            out_sv = sv
            plan = ctx.window_plan_direct(sv.coords, sv.mask, offs,
                                          stride=sv.stride)
        else:
            out_sv = ctx.strided(sv, 2)
            plan = ctx.window_plan_cross(sv, out_sv, offs, expanding=True)
        bl = self._block_live(ctx, subset, w_rows)
        if bl is not None:
            self.route = "blocksparse"
            w, live = self._blocksparse_inputs(
                bl, plan, ctx.block_live_granularity, subset, w_rows)
            out_f = window_conv_apply_blocksparse(
                sv.feats, plan, w, bl, self.bias, compute_dtype=cd,
                block=ctx.block_live_granularity, live=live, masked=True,
            ).to(cd)
        else:
            self.route = "windowed"
            w = self._kernel_rows(subset, w_rows)
            if s1:
                inv_plan = (
                    ctx.window_plan_direct(sv.coords, sv.mask, offs,
                                           transpose=True, stride=sv.stride)
                    if self.input_grad else None
                )
            else:
                inv_plan = ctx.window_plan_cross(out_sv, sv, offs,
                                                 transpose=True)
            out_f = window_conv_apply(
                sv.feats, plan, inv_plan, w, self.bias,
                compute_dtype=cd, input_grad=self.input_grad or not s1,
            ).to(cd)
        out_f = ctx.level_poison(out_sv.coords, out_f)
        return SparseVoxels(coords=out_sv.coords, feats=out_f,
                            mask=out_sv.mask, stride=out_sv.stride)

    def _kernel_rows(self, subset, w_rows):
        """The kernel's rows in the plan's offset order: a subset's rows,
        or the padded rows ``w_rows`` (-1 = a zero-weight repeat)."""
        w = self.kernel
        if w_rows is not None:
            return torch.where(
                const(w_rows >= 0, torch.bool, w.device)[:, None, None],
                w[const(np.clip(w_rows, 0, None), torch.int64, w.device)],
                0.0)
        if subset is not None:
            return w[const(subset, torch.int64, w.device)]
        return w

    def _block_live(self, ctx, subset, w_rows):
        """This conv's block liveness, re-indexed to the plan's offset
        rows, or None when the block-sparse forward does not apply (no
        entry, or fewer than 25 % dead blocks)."""
        if not ctx.block_live_map:
            return None
        bl = ctx.block_live_map.get(self.path)
        if bl is None:
            return None
        bl = np.asarray(bl)
        if w_rows is not None:
            bl = np.where((w_rows >= 0)[:, None, None],
                          bl[np.clip(w_rows, 0, None)], False)
        elif subset is not None:
            bl = bl[list(subset)]
        if bl.all() or 1.0 - bl.sum() / bl.size < BLOCK_SPARSE_MIN_DEAD:
            return None
        return bl

    def _blocksparse_inputs(self, bl, plan, block, subset, w_rows):
        """K5's inputs for this conv: its kernel rows with every dead block
        of ``bl`` zeroed, and ``bl`` in K5's form on the device. Made once
        and kept while the kernel parameter, its rows, the liveness and the
        plan's offset order stay the same, as they do over the forwards of
        one checkpoint."""
        k = self.kernel
        if torch.is_grad_enabled() and k.requires_grad:
            raise RuntimeError("the block-sparse conv is forward only: run "
                               "it under torch.no_grad() or inference_mode()")
        g_count, _, m, _ = plan.idx.shape
        key = (k.data_ptr(), k._version, str(k.device), subset,
               None if w_rows is None else w_rows.tobytes(), bl.tobytes(),
               bl.shape, block, plan.perm, g_count, m)
        if key != self._bs_cache[0]:
            with torch.no_grad():
                self._bs_cache = (
                    key,
                    mask_dead_blocks(self._kernel_rows(subset, w_rows), bl,
                                     block),
                    block_live_tensor(bl, plan.perm, g_count, m, k.device))
        return self._bs_cache[1:]

    def _resident_conv(self, sv, ctx, zaxis):
        """A blockable conv under "block_resident": the level enters its
        cells (if it is not there yet); a k3/s1 conv stays on them, a
        k2/s2 or k1/s2 conv steps down in-block to the coarser level's
        cells."""
        self.route = "block_resident"
        cd = self.compute_dtype
        if sv.feats.dtype != cd:
            # cast before densifying: the scatter moves fewer bytes
            sv = sv.replace(feats=sv.feats.to(cd))
        if not isinstance(sv, BlockVoxels):
            sv = ctx.to_block(sv)
        w = self.kernel.to(cd)
        if self.kernel_size == 3:
            if zaxis is not None:
                out = sv.replace(feats=br.conv3_zaxis_cells(
                    sv, w[const(zaxis, torch.int64, w.device)]))
            else:
                out = sv.replace(feats=br.conv3_cells(sv, w))
        else:
            coarse_sv, layout, cmask, trans = ctx.level_transition(sv)
            if self.kernel_size == 2:
                out_f = br.down_conv2(sv, w, layout, trans)
            else:
                out_f = br.down_sample_conv1(sv, w[0], layout, trans)
            if ctx.overflow_guard:
                out_f = br.overflow_poison(out_f, layout)
            out = BlockVoxels(coords=coarse_sv.coords,
                              row_mask=coarse_sv.mask, feats=out_f,
                              mask=cmask, layout=layout,
                              stride=coarse_sv.stride)
        if self.bias is not None:
            out = out.replace(feats=remask(out, out.feats + self.bias))
        return out.replace(feats=out.feats.to(cd))

    def _block_conv(self, sv, ctx):
        """A dense k3/s1 conv under "block": through 4^3 blocks made for
        this level."""
        self.route = "block"
        cd = self.compute_dtype
        layout = ctx.block_layout(sv.coords, sv.mask, sv.stride)
        out_f = block_conv3(layout, sv.feats.to(cd), self.kernel.to(cd))
        if ctx.overflow_guard:
            # the rows a full cap left out would read zeros: poison, as
            # "block_resident" does (the reference drops them silently)
            out_f = br.overflow_poison(out_f, layout)
        if self.bias is not None:
            out_f = out_f + self.bias
        return sv.replace(feats=out_f.to(cd))

    def _row_conv(self, sv, ctx, offs, subset):
        """The row path (a kernel map, then K6) for any kernel size,
        stride, dilation and offset subset; under "window" a
        stride-preserving conv with uniform offset groups runs K2/K3 on
        plans from the map instead. The inverse map is built only when
        autograd may need it (or the windowed guard reads it)."""
        self.route = "row"
        out_sv = ctx.strided(sv, self.stride) if self.stride > 1 else sv
        window = (ctx.use_window() and out_sv.stride == sv.stride
                  and _window_groups_ok(offs))
        km = ctx.kernel_map(sv.coords, sv.mask, out_sv.coords, out_sv.mask,
                            offs, in_stride=sv.stride)
        inv = None
        if torch.is_grad_enabled() or window:
            inv = ctx.kernel_map(out_sv.coords, out_sv.mask, sv.coords,
                                 sv.mask, offs, transpose=True,
                                 in_stride=out_sv.stride)
        w = self._kernel_rows(subset, None)
        if window:
            self.route = "window"
            plan = ctx.window_plan(km, sv.capacity, offs)
            inv_plan = ctx.window_plan(inv, out_sv.capacity, offs)
            out_f = window_conv_apply(
                sv.feats, plan, inv_plan, w, self.bias,
                compute_dtype=self.compute_dtype).to(self.compute_dtype)
            return sv.replace(feats=out_f)
        out_f = sparse_conv_apply(sv.feats, km, w, self.bias,
                                  compute_dtype=self.compute_dtype,
                                  inv_map=inv).to(self.compute_dtype)
        if out_sv is not sv:
            out_f = ctx.level_poison(out_sv.coords, out_f)
        return SparseVoxels(coords=out_sv.coords, feats=out_f,
                            mask=out_sv.mask, stride=out_sv.stride)


class SparseConvTranspose(nn.Module):
    """Stride-2 transposed conv onto the cached finer level ``target``
    (``kernel_size`` 2, or 3 as in ResUNet2's decoder). A k2 conv on the
    fully-windowed path takes a plan that is the transpose of the encoder
    down conv's, and its inverse plan is that down conv's own plan. On
    the row path (every k3 transpose, as in the reference) its map is the
    matching forward map inverted (the context's cache), with the forward
    map as its inverse. Dense in every sparse mode, as in the reference.
    ``route`` records the path of the last forward."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 kernel_size: int = 2):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel_size = kernel_size
        self.route = None
        self.kernel = nn.Parameter(torch.zeros(kernel_size ** 3, in_channels,
                                               out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, sv, ctx: CoordinateContext, target):
        # offsets in units of the finer (output) level's stride: the
        # adjoint of the down conv that made ``sv`` from ``target``
        offs = kernel_offsets(self.kernel_size, target.stride)
        self.route = ctx.conv_route(self.kernel_size == 2)
        if (self.route == "row" and self.kernel_size == 2
                and ctx.use_block_resident()):
            return self._resident(sv, ctx, target)
        sv, target = as_rows(sv), as_rows(target)
        if self.route == "windowed":
            plan = ctx.window_plan_cross(sv, target, offs, transpose=True)
            inv_plan = ctx.window_plan_cross(target, sv, offs,
                                             expanding=True)
            out_f = window_conv_apply(
                sv.feats, plan, inv_plan, self.kernel, self.bias,
                compute_dtype=self.compute_dtype,
            ).to(self.compute_dtype)
            out_f = ctx.level_poison(target.coords, out_f)
        else:
            km = ctx.kernel_map(sv.coords, sv.mask, target.coords,
                                target.mask, offs, transpose=True,
                                in_stride=sv.stride)
            inv = None
            if torch.is_grad_enabled():
                inv = ctx.kernel_map(target.coords, target.mask, sv.coords,
                                     sv.mask, offs, in_stride=target.stride)
            out_f = sparse_conv_apply(
                sv.feats, km, self.kernel, self.bias,
                compute_dtype=self.compute_dtype, inv_map=inv,
            ).to(self.compute_dtype)
        return SparseVoxels(coords=target.coords, feats=out_f,
                            mask=target.mask, stride=target.stride)

    def _resident(self, sv, ctx, target):
        """The k2 transpose under "block_resident": each fine block
        expands its chunk of the coarse cells, through the transition the
        encoder's down conv built (the context returns it)."""
        self.route = "block_resident"
        cd = self.compute_dtype
        if not isinstance(sv, BlockVoxels):
            sv = ctx.to_block(sv)
        if sv.feats.dtype != cd:
            sv = sv.replace(feats=sv.feats.to(cd))
        t_mask = (target.row_mask if isinstance(target, BlockVoxels)
                  else target.mask)
        _, _, _, trans = ctx.level_transition_for(
            target.coords, t_mask, target.stride, sv.feats.dtype)
        layout = ctx.block_layout(target.coords, t_mask, target.stride)
        cmask = ctx.cell_mask(layout)
        out_f = br.up_conv2(sv, self.kernel.to(cd), cmask, trans)
        if ctx.overflow_guard:
            out_f = br.overflow_poison(out_f, layout)
        if self.bias is not None:
            out_f = torch.where(cmask[..., None], out_f + self.bias, 0)
        return BlockVoxels(coords=target.coords, row_mask=t_mask,
                           feats=out_f.to(cd), mask=cmask, layout=layout,
                           stride=target.stride)


class SparsePool(nn.Module):
    """Strided window pooling (sum, avg or max) over a row kernel map onto
    the next coarser level, e.g. the ResNet stem's k2/s2 sum pooling."""

    def __init__(self, kernel_size: int = 2, stride: int = 2,
                 mode: str = "sum"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.mode = mode

    def forward(self, sv, ctx: CoordinateContext):
        if (isinstance(sv, BlockVoxels) and self.kernel_size == 2
                and self.stride == 2):
            coarse_sv, layout, cmask, trans = ctx.level_transition(sv)
            out_f = br.pool2_cells(sv, self.mode, layout, trans)
            if ctx.overflow_guard:
                out_f = br.overflow_poison(out_f, layout)
            return BlockVoxels(coords=coarse_sv.coords,
                               row_mask=coarse_sv.mask, feats=out_f,
                               mask=cmask, layout=layout,
                               stride=coarse_sv.stride)
        sv = as_rows(sv)
        offs = kernel_offsets(self.kernel_size, sv.stride)
        out_sv = ctx.strided(sv, self.stride) if self.stride > 1 else sv
        km = ctx.kernel_map(sv.coords, sv.mask, out_sv.coords, out_sv.mask,
                            offs, in_stride=sv.stride)
        out_f = window_pool(sv.masked_feats(), km, self.mode)
        if out_sv is not sv:
            out_f = ctx.level_poison(out_sv.coords, out_f)
        return SparseVoxels(coords=out_sv.coords, feats=out_f,
                            mask=out_sv.mask, stride=out_sv.stride)


class GlobalPool(nn.Module):
    """Pooling of each batch element's rows to dense [num_batches, C]
    (avg, max or sum)."""

    def __init__(self, mode: str = "avg", num_batches: int = 1):
        super().__init__()
        self.mode = mode
        self.num_batches = num_batches

    def forward(self, sv: SparseVoxels) -> torch.Tensor:
        return global_pool(sv.masked_feats(), sv.batch_ids(self.num_batches),
                           self.num_batches, self.mode)


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
        return sv.replace(feats=remask(sv, batch_norm_apply(
            sv.feats, mean, var, self.weight, self.bias, self.eps,
        )))


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

    def apply(sv):
        # on cells, a function that does not map 0 to 0 would fill the
        # unoccupied ones
        return sv.replace(feats=remask(sv, fn(sv.feats)))

    return apply


class MinkLayerNorm(nn.Module):
    """LayerNorm of each row over its channels (no statistics kept; the
    same in train and eval mode)."""

    flax_name = "MinkLayerNorm"

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, sv: SparseVoxels) -> SparseVoxels:
        return sv.replace(feats=remask(sv, layer_norm(
            sv.feats, self.weight, self.bias, self.eps)))


class MinkInstanceNorm(nn.Module):
    """Per-scene norm: each (scene, channel)'s mean and variance over the
    scene's valid rows (``num_batches`` scenes; padding rows count in
    none). The same in train and eval mode."""

    flax_name = "MinkInstanceNorm"

    def __init__(self, num_channels: int, num_batches: int = 1,
                 eps: float = 1e-5):
        super().__init__()
        self.num_batches = num_batches
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, sv: SparseVoxels) -> SparseVoxels:
        # rows, or a resident level's cells flattened
        flat = sv.feats.reshape(-1, sv.num_channels)
        mean, var = instance_norm_stats(
            flat, sv.batch_ids(self.num_batches), self.num_batches)
        f = (flat.to(torch.float32) - mean) * torch.rsqrt(var + self.eps)
        out = (f * self.weight + self.bias).to(sv.feats.dtype)
        return sv.replace(feats=remask(sv, out.reshape(sv.feats.shape)))


def make_norm(norm_type: str, num_channels: int, *,
              bn_momentum: float = 0.1, num_batches: int = 1) -> nn.Module:
    """Norm factory (the reference's get_norm): BatchNorm ("BN"),
    instance norm ("IN", over ``num_batches`` scenes), LayerNorm ("LN")
    and PowerNorm ("PN")."""
    if norm_type == "BN":
        return MaskedBatchNorm(num_channels, momentum=bn_momentum)
    if norm_type == "IN":
        return MinkInstanceNorm(num_channels, num_batches=num_batches)
    if norm_type == "LN":
        return MinkLayerNorm(num_channels)
    if norm_type == "PN":
        from nerf_downstream_tpu_torch.models.mink.powernorm import (
            MinkPowerNorm,
        )

        return MinkPowerNorm(num_channels)
    raise ValueError(f"unknown norm type {norm_type!r}")


def cat(a, b):
    """Feature concat of two levels on the same coordinate set (UNet skip),
    promoting to the wider type as the reference does. A resident level
    meeting rows (one side left the blocks, e.g. at a ZAXIS conv) is read
    back to rows first."""
    if isinstance(a, BlockVoxels) != isinstance(b, BlockVoxels):
        a, b = as_rows(a), as_rows(b)
    dt = torch.promote_types(a.feats.dtype, b.feats.dtype)
    return a.replace(feats=torch.cat([a.feats.to(dt), b.feats.to(dt)], -1))
