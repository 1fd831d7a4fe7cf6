"""Block-resident stride levels: a whole level kept in the dense block
layout (counterpart of ``nerf_downstream_tpu/ops/block_resident.py``).

- ``BlockVoxels`` duck-types ``SparseVoxels``: ``feats`` are the cells
  [(Bb + 1), 4, 4, 4, C], ``mask`` the cell occupancy, so norms,
  activations, residual adds, skip concats and 1x1 convs run on cells
  unchanged;
- k3/s1 convs call the halo + conv core directly (``conv3_cells``; a
  ZAXIS subset takes ``conv3_zaxis_cells``, whose halo is the two z-face
  slices);
- k2/s2 convs, k1/s2 convs and poolings read the cells inside one block
  (block origins are even in cell units, so every 2^3 window stays in its
  block) and re-block into the coarser level with one scatter per
  transition (``down_conv2``, ``down_sample_conv1``, ``pool2_cells``);
- k2/s2 transpose convs are the adjoint: each fine block gathers its 2^3
  chunk from the coarse level and expands it (``up_conv2``).

Invariant: ``BlockVoxels.feats`` is zero at unoccupied cells, the
sentinel block included. ``to_block`` establishes it; every op that
breaks it (a norm's affine, a bias, a conv's writes into empty cells of
occupied blocks) re-masks its output.

The dense convolutions are ``block_conv.conv`` (cuDNN without TF32,
deterministic algorithms; the reference's XLA convs), the halo and
``_zext`` carry the reference's gather-only adjoints, and the re-block
scatters write unique slots (fine blocks are unique).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nerf_downstream_tpu_torch.ops.block_conv import (
    BLOCK,
    CELLS,
    BlockLayout,
    block_core,
    conv,
    densify,
)
from nerf_downstream_tpu_torch.ops.scatter import gather_rows
from nerf_downstream_tpu_torch.sparse import kernels
from nerf_downstream_tpu_torch.sparse.types import SparseVoxels

# a 2^3 chunk's cells in cell order (x * 16 + y * 4 + z), x-major
_CHUNK_OFFS = np.array(
    [i * BLOCK * BLOCK + j * BLOCK + k
     for i in (0, 1) for j in (0, 1) for k in (0, 1)],
    np.int64,
)


@dataclasses.dataclass(frozen=True)
class LevelTransition:
    """Fine level -> coarse level: ``slot_base[b]`` is the flat coarse
    cell of fine block b's 2^3 chunk origin; ``valid[b]`` whether fine
    block b has a coarse block."""

    slot_base: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BlockVoxels:
    """A level resident in dense cells: coords int32[N, 4] and row_mask
    bool[N] (the level's rows, which key the context's caches); feats
    [(Bb + 1), 4, 4, 4, C]; mask bool[(Bb + 1), 4, 4, 4]; layout; stride."""

    coords: torch.Tensor
    row_mask: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor
    layout: BlockLayout
    stride: int = 1

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    def batch_ids(self, num_batches: int) -> torch.Tensor:
        """Batch index per cell, flat (pairs with ``masked_feats``);
        unoccupied cells map to ``num_batches``."""
        lay = self.layout
        blk = torch.where(lay.block_mask, lay.block_coords[:, 0],
                          num_batches).to(torch.int32)
        blk = torch.cat([blk, blk.new_full((1,), num_batches)])
        per_cell = blk.repeat_interleave(CELLS)
        return torch.where(self.mask.reshape(-1), per_cell, num_batches)

    def masked_feats(self) -> torch.Tensor:
        """Flat [(Bb + 1) * 64, C] cells, zero where unoccupied."""
        flat = self.feats.reshape(-1, self.num_channels)
        return torch.where(self.mask.reshape(-1)[:, None], flat, 0)

    def replace(self, **changes) -> "BlockVoxels":
        return dataclasses.replace(self, **changes)


def remask(bv: BlockVoxels, feats: torch.Tensor) -> torch.Tensor:
    """``feats`` zeroed at ``bv``'s unoccupied cells (no-op on rows)."""
    if isinstance(bv, BlockVoxels):
        return torch.where(bv.mask[..., None], feats, 0)
    return feats


def cell_mask_of(layout: BlockLayout) -> torch.Tensor:
    """Cell occupancy bool[(Bb + 1), 4, 4, 4] (sentinel block False)."""
    bb = layout.n_blocks
    m = torch.zeros(((bb + 1) * CELLS,), dtype=torch.bool,
                    device=layout.row_slot.device)
    # valid rows own their cells; the others all write False to the
    # sentinel's first cell
    m[layout.row_slot.long()] = layout.row_valid
    return m.reshape(bb + 1, BLOCK, BLOCK, BLOCK)


def overflow_poison(feats: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """NaN-poison ``feats`` if the block cap dropped rows (fail loud)."""
    scale = torch.where(layout.overflow > 0, float("nan"), 1.0)
    return feats * scale.to(feats.dtype)


def to_block(sv: SparseVoxels, layout: BlockLayout, cell_mask: torch.Tensor,
             guard: bool = True) -> BlockVoxels:
    """Enter the block-resident layout (once per level)."""
    c = sv.feats.shape[-1]
    cells = densify(layout, sv.feats).reshape(layout.n_blocks + 1, BLOCK,
                                              BLOCK, BLOCK, c)
    if guard:
        cells = overflow_poison(cells, layout)
    return BlockVoxels(coords=sv.coords, row_mask=sv.mask, feats=cells,
                       mask=cell_mask, layout=layout, stride=sv.stride)


def to_rows(bv: BlockVoxels) -> SparseVoxels:
    """Row features of a resident level (at its exit or the output)."""
    flat = bv.feats.reshape(-1, bv.num_channels)
    rows = gather_rows(flat, bv.layout.row_slot.clamp(0, flat.shape[0] - 1))
    rows = torch.where(bv.layout.row_valid[:, None], rows, 0)
    return SparseVoxels(coords=bv.coords, feats=rows, mask=bv.row_mask,
                        stride=bv.stride)


def _pad_block(out: torch.Tensor) -> torch.Tensor:
    """[Bb, 4, 4, 4, C] + the zero sentinel block."""
    return torch.cat([out, out.new_zeros((1,) + out.shape[1:])])


def conv3_cells(bv: BlockVoxels, w: torch.Tensor) -> torch.Tensor:
    """k3/s1 conv on resident cells, re-masked (the conv writes into the
    empty cells of occupied blocks, which the in-block ops must not
    read)."""
    out = _pad_block(block_core(bv.feats, bv.layout.nbr, w))
    return remask(bv, out)


_ZM_K, _ZP_K = 4, 22  # OFFS rows of (0, 0, -1) and (0, 0, 1)


class _ZExt(torch.autograd.Function):
    """z-extended tiles [Bb, 4, 4, 6, C]: the block with its two z-face
    neighbours' slices; the adjoint by gathers (the opposite offset
    inverts the neighbour relation)."""

    @staticmethod
    def forward(ctx, blocks, nbr):
        ctx.save_for_backward(nbr)
        bb = blocks.shape[0] - 1
        nbr = nbr.long()
        zm = blocks[:, :, :, 3:4][nbr[_ZM_K]]
        zp = blocks[:, :, :, 0:1][nbr[_ZP_K]]
        return torch.cat([zm, blocks[:bb], zp], 3)

    @staticmethod
    def backward(ctx, g):
        (nbr,) = ctx.saved_tensors
        nbr = nbr.long()
        bb = g.shape[0]
        g_ext = torch.cat([g, g.new_zeros((1,) + g.shape[1:])])
        d = g.new_zeros((bb + 1, BLOCK, BLOCK, BLOCK, g.shape[-1]))
        d[:bb] = g[:, :, :, 1:BLOCK + 1]
        d[:bb, :, :, BLOCK - 1:BLOCK] += g_ext[:, :, :, 0:1][nbr[_ZP_K]]
        d[:bb, :, :, 0:1] += g_ext[:, :, :, BLOCK + 1:BLOCK + 2][nbr[_ZM_K]]
        return d, None


def conv3_zaxis_cells(bv: BlockVoxels, w3: torch.Tensor) -> torch.Tensor:
    """ZAXIS k[1, 1, 3]/s1 conv on resident cells: ``w3`` [3, Cin, Cout]
    in dz order (-1, 0, 1); re-masked."""
    tile = _ZExt.apply(bv.feats, bv.layout.nbr)
    filt = w3.permute(2, 1, 0)[:, :, None, None, :]
    return remask(bv, _pad_block(conv(tile, filt)))


def _w222(w: torch.Tensor) -> torch.Tensor:
    """[8, Cin, Cout] (x fastest) -> [Cin, Cout, x, y, z]."""
    return w.reshape(2, 2, 2, w.shape[1], w.shape[2]).permute(3, 4, 2, 1, 0)


def _scatter_chunks(chunk: torch.Tensor, coarse_layout: BlockLayout,
                    trans: LevelTransition) -> torch.Tensor:
    """Chunks [Bbf, 8, C] -> coarse cells [(Bbc + 1), 4, 4, 4, C]; fine
    blocks without a coarse block drop out (one slot past the cells)."""
    bbc = coarse_layout.n_blocks
    cout = chunk.shape[-1]
    offs = torch.as_tensor(_CHUNK_OFFS, device=chunk.device)
    slots = trans.slot_base.long()[:, None] + offs
    slots = torch.where(trans.valid[:, None], slots, (bbc + 1) * CELLS)
    flat = chunk.new_zeros(((bbc + 1) * CELLS + 1, cout)).index_put(
        (slots.reshape(-1),), chunk.reshape(-1, cout))
    return flat[:-1].reshape(bbc + 1, BLOCK, BLOCK, BLOCK, cout)


def _gather_chunks(coarse: torch.Tensor, trans: LevelTransition
                   ) -> torch.Tensor:
    """Coarse cells -> chunks [Bbf, 2, 2, 2, C] (fine blocks without a
    coarse block read the zero sentinel)."""
    c = coarse.shape[-1]
    flat = coarse.reshape(-1, c)
    base = torch.where(trans.valid, trans.slot_base.long(),
                       flat.shape[0] - CELLS)
    offs = torch.as_tensor(_CHUNK_OFFS, device=coarse.device)
    return gather_rows(flat, base[:, None] + offs).reshape(-1, 2, 2, 2, c)


def down_conv2(bv: BlockVoxels, w: torch.Tensor, coarse_layout: BlockLayout,
               trans: LevelTransition) -> torch.Tensor:
    """k2/s2 conv: a stride-2 VALID conv per block, then one re-block
    scatter. ``w`` [8, Cin, Cout]; coarse cells out."""
    filt = _w222(w).transpose(0, 1)  # [Cout, Cin, 2, 2, 2]
    chunk = conv(bv.feats[:bv.layout.n_blocks], filt, stride=2)
    return _scatter_chunks(chunk.reshape(-1, 8, w.shape[-1]), coarse_layout,
                           trans)


def up_conv2(coarse: BlockVoxels, w: torch.Tensor,
             fine_cell_mask: torch.Tensor, trans: LevelTransition
             ) -> torch.Tensor:
    """k2/up-stride-2 transpose conv onto the finer level: each fine cell
    takes its covering coarse cell times the weight of its corner (the
    adjoint of ``down_conv2``). Fine cells out, re-masked."""
    chunk = _gather_chunks(coarse.feats, trans)
    out = conv(chunk, _w222(w), stride=2, transposed=True)
    return torch.where(fine_cell_mask[..., None], _pad_block(out), 0)


def down_sample_conv1(bv: BlockVoxels, w1: torch.Tensor,
                      coarse_layout: BlockLayout,
                      trans: LevelTransition) -> torch.Tensor:
    """k1/s2 conv (a ResNet shortcut): each chunk's origin cell times the
    1x1 weight ``w1`` [Cin, Cout] (f32 sums), re-blocked."""
    origin = bv.feats[:bv.layout.n_blocks, ::2, ::2, ::2]
    chunk = (origin.to(torch.float32) @ w1.to(origin.dtype).to(
        torch.float32)).to(bv.feats.dtype)
    return _scatter_chunks(chunk.reshape(-1, 8, w1.shape[-1]),
                           coarse_layout, trans)


def pool2_cells(bv: BlockVoxels, mode: str, coarse_layout: BlockLayout,
                trans: LevelTransition) -> torch.Tensor:
    """k2/s2 pooling in-block (sum, avg over the present cells, or max),
    the semantics of ``ops.pool.window_pool`` on a kernel map."""
    c = bv.num_channels
    bbf = bv.layout.n_blocks
    blocks = bv.feats[:bbf]
    m = bv.mask[:bbf][..., None]

    def corners(x):
        return [x[:, i::2, j::2, k::2]
                for i in (0, 1) for j in (0, 1) for k in (0, 1)]

    if mode == "max":
        neg = blocks.new_tensor(torch.finfo(torch.float32).min)
        parts = corners(torch.where(m, blocks, neg))
        red = parts[0]
        for p in parts[1:]:
            red = torch.maximum(red, p)
        red = torch.where(red == neg, 0, red)
    else:
        parts = corners(torch.where(m, blocks, 0).to(torch.float32))
        red = sum(parts[1:], parts[0])
        if mode == "avg":
            mparts = corners(m.expand(blocks.shape).to(torch.float32))
            cnt = sum(mparts[1:], mparts[0])
            red = red / torch.clamp(cnt, min=1.0)
        elif mode != "sum":
            raise ValueError(f"unknown pool mode {mode!r}")
        red = red.to(bv.feats.dtype)
    return _scatter_chunks(red.reshape(-1, 8, c), coarse_layout, trans)


def build_level_transition(fine_layout: BlockLayout,
                           coarse_layout: BlockLayout, coarse_grid,
                           coarse_origin, num_batches: int,
                           coarse_block_extent: int) -> LevelTransition:
    """Each fine block's chunk slot in the coarse level: fine block (b, x,
    y, z) covers coarse cells [2x, 2x + 2), the chunk of coarse block
    floor(xyz / 2) at corner xyz mod 2 (one lookup in the coarse block
    grid)."""
    fb = fine_layout.block_coords
    bbc = coarse_layout.n_blocks
    q = torch.cat([fb[:, :1], torch.div(fb[:, 1:], 2, rounding_mode="floor")],
                  1)
    rank = kernels.lookup_grid(coarse_grid, coarse_origin, num_batches,
                               coarse_block_extent, 1, q,
                               fine_layout.block_mask, bbc)
    corner = torch.remainder(fb[:, 1:], 2)
    base = (rank * CELLS + corner[:, 0] * (2 * BLOCK * BLOCK)
            + corner[:, 1] * (2 * BLOCK) + corner[:, 2] * 2).to(torch.int32)
    valid = fine_layout.block_mask & (rank < bbc)
    return LevelTransition(slot_base=base, valid=valid)
