"""Block-dense sparse convolution (counterpart of
``nerf_downstream_tpu/ops/block_conv.py``).

Surface shells cluster into locally dense 4^3 blocks. This path:

1. partitions the rows into occupied 4^3 blocks (dedup of block keys, a
   neighbour table through a dense grid over block coordinates);
2. writes the row features into dense cells [(Bb + 1), 4, 4, 4, C] (the
   last block is an all-zero sentinel);
3. builds each block's 6^3 halo tile from the boundary slices of its 26
   neighbours;
4. runs a dense VALID 3D convolution over the tiles;
5. reads the occupied cells back to rows.

The dense convolution is the reference's ``lax.conv_general_dilated``
(XLA, not a Pallas kernel) and here cuDNN's, through ``conv`` with
TF32 off and deterministic algorithms chosen, so that an f32 conv stays
f32 and a training step repeats bit for bit; its backward runs under the
same settings. ``block_conv3``'s gradient is one
``torch.autograd.Function`` with the reference's scatter-free VJP: the
input gradient is a VALID conv of the halo of the output gradient with
the flipped, transposed filter, the weight gradient the filter gradient
of the recomputed input tile, and the halo's adjoint is gathers and
slice adds (block coordinates are unique, so ``nbr[26 - k]`` inverts
``nbr[k]``).

Cells are ordered x-major (cell = (x * 4 + y) * 4 + z), so a cell tensor's
spatial axes are (x, y, z); kernel rows enumerate offsets x fastest (the
``kernel_offsets`` order), which ``_filt`` turns into cuDNN's
[Cout, Cin, x, y, z].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nerf_downstream_tpu_torch.ops.scatter import gather_rows
from nerf_downstream_tpu_torch.sparse import kernels

BLOCK = 4
CELLS = BLOCK ** 3

# neighbour offsets, x fastest (the kernel_offsets order)
OFFS = np.array(
    [(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)],
    np.int32,
)


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """block_coords int32[Bb, 4] in block units; block_mask bool[Bb];
    row_slot int32[N] = block rank * 64 + cell (Bb * 64 for rows without
    a block); row_valid bool[N]; nbr int32[27, Bb] neighbour block ranks
    (Bb = none); overflow int32 count of valid rows past the block cap."""

    block_coords: torch.Tensor
    block_mask: torch.Tensor
    row_slot: torch.Tensor
    row_valid: torch.Tensor
    nbr: torch.Tensor
    overflow: torch.Tensor
    n_blocks: int = 0


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def block_grid(block_coords, block_mask, num_batches: int, grid_extent: int):
    """Dense grid index over block coordinates (the neighbour table's and
    the level transition's lookup): (grid, origin, extent)."""
    block_extent = 1 << max(
        1, int(np.ceil(np.log2(max(grid_extent // BLOCK, 2)))))
    grid, origin = kernels.build_grid_index(block_coords, block_mask,
                                            num_batches, block_extent, 1)
    return grid, origin, block_extent


def build_block_layout(coords, mask, stride: int, n_blocks_cap: int,
                       num_batches: int, grid_extent: int = 512
                       ) -> BlockLayout:
    """Partition the rows of a level at ``stride`` into at most
    ``n_blocks_cap`` 4^3 blocks; rows of blocks past the cap drop out and
    count in ``overflow``."""
    cell_xyz = _floor_div(coords[:, 1:], stride)
    block_xyz = _floor_div(cell_xyz, BLOCK)
    in_block = cell_xyz - block_xyz * BLOCK
    bcoords = torch.cat([coords[:, :1], block_xyz], 1).to(torch.int32)
    uniq, uniq_mask, row_to_block = kernels.unique_coords(bcoords, mask)
    block_coords = uniq[:n_blocks_cap]
    block_mask = uniq_mask[:n_blocks_cap]
    over = row_to_block >= n_blocks_cap
    cell = (in_block[:, 0] * BLOCK + in_block[:, 1]) * BLOCK + in_block[:, 2]
    row_valid = mask & ~over
    row_slot = torch.where(row_valid, row_to_block * CELLS + cell,
                           n_blocks_cap * CELLS).to(torch.int32)
    grid, origin, extent = block_grid(block_coords, block_mask, num_batches,
                                      grid_extent)
    nbr = kernels.build_kernel_map_grid(
        grid, origin, num_batches, extent, 1, n_blocks_cap, block_coords,
        block_mask, OFFS)
    return BlockLayout(
        block_coords=block_coords, block_mask=block_mask, row_slot=row_slot,
        row_valid=row_valid, nbr=nbr,
        overflow=(mask & over).sum(dtype=torch.int32),
        n_blocks=n_blocks_cap,
    )


def densify(layout: BlockLayout, feats: torch.Tensor) -> torch.Tensor:
    """Rows -> dense cells [(Bb + 1) * 64, C]. Rows without a block write
    zeros to the sentinel block, which stays all-zero."""
    c = feats.shape[1]
    rows = torch.where(layout.row_valid[:, None], feats, 0)
    return feats.new_zeros(((layout.n_blocks + 1) * CELLS, c)).index_put(
        (layout.row_slot.long(),), rows)


def undensify(layout: BlockLayout, dense: torch.Tensor) -> torch.Tensor:
    """Dense cells [(Bb + 1) * 64, C] -> rows (rows without a block read
    the sentinel)."""
    return gather_rows(dense, layout.row_slot.clamp(0, dense.shape[0] - 1))


# ---- cuDNN convolutions, f32 without TF32, deterministic algorithms -------

def _flags():
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _conv_raw(x, w, stride: int = 1, transposed: bool = False):
    with _flags():
        return torch.ops.aten.convolution(x, w, None, [stride] * 3, [0] * 3,
                                          [1] * 3, transposed, [0] * 3, 1)


def _conv_grads(g, x, w, stride: int, transposed: bool, mask):
    with _flags():
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, [stride] * 3, [0] * 3, [1] * 3, transposed,
            [0] * 3, 1, [mask[0], mask[1], False])
    return dx, dw


class _Conv(torch.autograd.Function):
    """A VALID 3D convolution (or its transpose) [B, C, D, H, W] whose
    forward and backward both run under ``_flags``."""

    @staticmethod
    def forward(ctx, x, w, stride, transposed):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, transposed)
        return _conv_raw(x, w, stride, transposed)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _conv_grads(g.contiguous(), x, w, *ctx.conf,
                             ctx.needs_input_grad[:2])
        return dx, dw, None, None


def conv(cells: torch.Tensor, filt: torch.Tensor, stride: int = 1,
         transposed: bool = False) -> torch.Tensor:
    """VALID conv of channels-last cells [B, X, Y, Z, C] with a cuDNN
    filter (``[Cout, Cin, kx, ky, kz]``, or ``[Cin, Cout, ...]`` when
    ``transposed``): [B, X', Y', Z', Cout], in the cells' type."""
    x = cells.permute(0, 4, 1, 2, 3).contiguous()
    out = _Conv.apply(x, filt.to(cells.dtype).contiguous(), stride,
                      transposed)
    return out.permute(0, 2, 3, 4, 1)


def _filt(w: torch.Tensor, k: int = 3) -> torch.Tensor:
    """[k^3, Cin, Cout] (x fastest) -> cuDNN's [Cout, Cin, x, y, z]."""
    c, cout = w.shape[1], w.shape[2]
    return w.reshape(k, k, k, c, cout).permute(4, 3, 2, 1, 0)


# ---- halo tiles and their adjoint -----------------------------------------

def _src(d: int) -> slice:
    """The neighbour's boundary slice that lands in the tile at offset d."""
    return {-1: slice(BLOCK - 1, BLOCK), 0: slice(0, BLOCK), 1: slice(0, 1)}[d]


def _dst(d: int) -> slice:
    """The tile slice that the neighbour at offset d fills."""
    return {-1: slice(0, 1), 0: slice(1, BLOCK + 1),
            1: slice(BLOCK + 1, BLOCK + 2)}[d]


def halo(blocks: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """[Bb, 6, 6, 6, C] tiles of ``blocks`` [(Bb + 1), 4, 4, 4, C]: each
    block with a one-cell rim from its 26 neighbours' boundary slices
    (sliced before the gather, so the gather moves only those cells)."""
    bb = blocks.shape[0] - 1
    nbr = nbr.long()
    planes = []
    for dz in (-1, 0, 1):
        strips = []
        for dy in (-1, 0, 1):
            pieces = []
            for dx in (-1, 0, 1):
                if (dx, dy, dz) == (0, 0, 0):
                    pieces.append(blocks[:bb])
                    continue
                k = (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)
                pre = blocks[:, _src(dx), _src(dy), _src(dz)]
                pieces.append(pre[nbr[k]])
            strips.append(torch.cat(pieces, 1))
        planes.append(torch.cat(strips, 2))
    return torch.cat(planes, 3)


def halo_adjoint(g: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``halo``: tile gradients [Bb, 6, 6, 6, C] -> block
    gradients [(Bb + 1), 4, 4, 4, C] (sentinel zero), by gathers:
    d_blocks[b][src(k)] += d_tile[nbr[26 - k][b]][dst(k)]."""
    bb = g.shape[0]
    nbr = nbr.long()
    g_ext = torch.cat([g, g.new_zeros((1,) + g.shape[1:])])
    d = g.new_zeros((bb + 1, BLOCK, BLOCK, BLOCK, g.shape[-1]))
    d[:bb] = g[:, 1:BLOCK + 1, 1:BLOCK + 1, 1:BLOCK + 1]
    for k in range(27):
        dx, dy, dz = (int(v) for v in OFFS[k])
        if (dx, dy, dz) == (0, 0, 0):
            continue
        piece = g_ext[:, _dst(dx), _dst(dy), _dst(dz)][nbr[26 - k]]
        d[:bb, _src(dx), _src(dy), _src(dz)] += piece
    return d


class _BlockCore(torch.autograd.Function):
    """k3/s1 conv on cells [(Bb + 1), 4, 4, 4, C] -> [Bb, 4, 4, 4, Cout]
    (the reference's ``block_core5``): halo + VALID conv forward, and the
    scatter-free VJP."""

    @staticmethod
    def forward(ctx, blocks, nbr, w):
        ctx.save_for_backward(blocks, nbr, w)
        tile = halo(blocks, nbr).permute(0, 4, 1, 2, 3).contiguous()
        out = _conv_raw(tile, _filt(w).contiguous())
        return out.permute(0, 2, 3, 4, 1)

    @staticmethod
    def backward(ctx, g):
        blocks, nbr, w = ctx.saved_tensors
        cout = w.shape[-1]
        filt = _filt(w).contiguous()
        d_blocks = d_w = None
        g = g.to(blocks.dtype)
        if ctx.needs_input_grad[0]:
            g_ext = torch.cat([g, g.new_zeros((1, BLOCK, BLOCK, BLOCK,
                                               cout))])
            g_tile = halo(g_ext, nbr).permute(0, 4, 1, 2, 3).contiguous()
            # out[q] = sum_f in[q + f - 1] W[f]  =>
            # d_in[p] = sum_f' g[p + f' - 1] W[2 - f']^T
            rev = filt.flip(2, 3, 4).transpose(0, 1).contiguous()
            d = _conv_raw(g_tile, rev).permute(0, 2, 3, 4, 1)
            d_blocks = torch.cat([d, d.new_zeros((1,) + d.shape[1:])])
        if ctx.needs_input_grad[2]:
            # filter gradient on a recomputed tile (one more halo; cheaper
            # than keeping the tiles alive between the passes)
            tile = halo(blocks, nbr).permute(0, 4, 1, 2, 3).contiguous()
            _, d_filt = _conv_grads(g.permute(0, 4, 1, 2, 3).contiguous(),
                                    tile, filt, 1, False, (False, True))
            d_w = d_filt.permute(4, 3, 2, 1, 0).reshape(w.shape).to(w.dtype)
        return d_blocks, None, d_w


def block_core(blocks: torch.Tensor, nbr: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """k3/s1 conv of resident cells [(Bb + 1), 4, 4, 4, C] with ``w``
    [27, C, Cout]: [Bb, 4, 4, 4, Cout] in the cells' type."""
    return _BlockCore.apply(blocks, nbr, w.to(blocks.dtype))


def block_conv3(layout: BlockLayout, feats: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """k3/s1 conv of a level's rows through dense blocks: densify, halo +
    conv, read back. ``w`` [27, Cin, Cout] (x fastest). Rows [N, Cout]
    f32, zero where a row has no block."""
    bb = layout.n_blocks
    c, cout = feats.shape[1], w.shape[-1]
    blocks = densify(layout, feats).reshape(bb + 1, BLOCK, BLOCK, BLOCK, c)
    out = block_core(blocks, layout.nbr, w)
    dense = torch.cat([out.reshape(bb * CELLS, cout),
                       out.new_zeros((CELLS, cout))])
    rows = undensify(layout, dense)
    valid = layout.row_slot < bb * CELLS
    return torch.where(valid[:, None], rows.to(torch.float32), 0.0)
