"""Per-forward coordinate context: window-plan, kernel-map, stride and
block-layout caches (counterpart of
``nerf_downstream_tpu/sparse/context.py``).

Every conv of a level reuses one window plan; plans, kernel maps, strided
levels and their overflow counters are cached by the identity of the
coordinate tensors. In eager PyTorch a freed tensor's ``id`` can be handed to a new
tensor, so every cache entry holds references to its key tensors: while
the entry lives, its ids cannot be reused. A context lives for one forward
pass.

The constructor takes the reference's arguments and is gin-configurable
under the same name (``CoordinateContext.window_size = 128``); the meaning
of each knob is documented on the reference class. ``method`` resolves as
the reference's does:

- "auto" with a ``grid_extent``, or "hybrid" (with or without one), is
  the fully-windowed path (``use_window_full``) for the convs it takes
  (k3/s1, k2/s2 and k1/s2 without dilation, the k2 transpose conv);
- "block_resident" with a ``grid_extent`` keeps each level in dense 4^3
  blocks (``use_block_resident``, ``to_block``, ``level_transition``;
  ``ops/block_resident.py``) for its k3/s1 convs (or their ZAXIS
  subset), k2/s2 and k1/s2 convs, k2 transposes and k2 poolings;
- "block" with a ``grid_extent`` runs each dense k3/s1 conv through
  blocks made for it (``use_block_conv``, ``block_layout``;
  ``ops/block_conv.py``);
- "window" runs every stride-preserving conv whose offsets form
  uniform (dx, dy) groups through a window plan made from its row kernel
  map (``use_window``, ``window_plan``; ``ops/window_conv.build_plan``);
- every other conv, and every conv under "row", "search", or "auto" and
  the block methods without an extent, takes the row path (a kernel map,
  then K6).

Block capacities: ``block_caps`` (per level, log2 of the stride) or
``capacity / (block_cap_divisor * stride^2)`` blocks, at least 64; a
level whose blocks overflow its cap NaN-poisons. ``overflow_guard =
False`` turns off the caps' NaN poisoning, as in the reference.
The pruned-eval knobs (``eval3d --sparsify``): ``valid_offsets_map``
{conv module path -> live offset tuple} is read by mode-1 convs;
``block_live_map`` {conv module path -> bool[K, nbi, nbo]} by every
windowed conv at inference, at granularity ``block_live_granularity``.
Row kernel maps use a dense grid index when ``grid_extent`` is set (and
``method`` is not "search"), else sort and binary search.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.sparse import kernels
from nerf_downstream_tpu_torch.sparse.types import SparseVoxels


def _level(stride: int) -> int:
    return max(0, int(round(float(np.log2(max(stride, 1))))))


@cfg.configurable("CoordinateContext")
class CoordinateContext:
    def __init__(
        self,
        num_batches: int = 1,
        grid_extent: int | None = None,
        method: str = "auto",
        block_cap_divisor: float = 3,
        block_caps: tuple | None = None,
        overflow_guard: bool = True,
        window_tile: int = 256,
        window_size: int = 512,
        window_blocks: int = 2,
        window_escape_cap=None,
        window_escape_tiles=64,
        window_expand_factor: int = 2,
        window_cross_blocks: int | None = None,
        level_caps: tuple | None = None,
        level_cap_decay: float | None = None,
        valid_offsets_map: dict | None = None,
        block_live_map: dict | None = None,
        block_live_granularity: int = 128,
    ):
        self.method = method
        self.block_cap_divisor = block_cap_divisor
        self.block_caps = block_caps
        self.overflow_guard = overflow_guard
        self.window_cross_blocks = window_cross_blocks
        self.level_cap_decay = level_cap_decay
        self.window_tile = window_tile
        self.window_size = window_size
        self.window_blocks = window_blocks
        self.window_escape_cap = window_escape_cap
        self.window_escape_tiles = window_escape_tiles
        self.window_expand_factor = window_expand_factor
        self.level_caps = level_caps
        self.num_batches = num_batches
        self.grid_extent = grid_extent
        self.valid_offsets_map = valid_offsets_map
        self.block_live_map = block_live_map
        self.block_live_granularity = block_live_granularity
        # key -> (key tensors kept alive, value)
        self._window_plans: dict = {}
        self._kmaps: dict = {}
        self._grids: dict = {}
        self._strided: dict = {}
        self._level_overflow: dict = {}
        self._block_layouts: dict = {}
        self._block_grids: dict = {}
        self._cell_masks: dict = {}
        self._transitions: dict = {}

    def use_window_full(self) -> bool:
        """The reference's resolution of the fully-windowed path: "hybrid",
        or "auto" with a configured grid extent."""
        return self.method == "hybrid" or (
            self.method == "auto" and self.grid_extent is not None)

    def conv_route(self, windowable: bool) -> str:
        """The path of a conv that the fully-windowed path may take:
        "windowed" when that path is on and the conv is one it takes
        (``windowable``), else "row" (the block methods and "window" pick
        their convs in the layers, ahead of the row path)."""
        return "windowed" if windowable and self.use_window_full() else "row"

    def use_window(self) -> bool:
        """Window plans from row kernel maps for stride-preserving convs."""
        return self.method == "window"

    def use_block_conv(self) -> bool:
        return self.method == "block" and self.grid_extent is not None

    def use_block_resident(self) -> bool:
        return (self.method == "block_resident"
                and self.grid_extent is not None)

    @staticmethod
    def _get(cache: dict, key):
        hit = cache.get(key)
        return None if hit is None else hit[1]

    @staticmethod
    def _put(cache: dict, key, refs: tuple, value):
        cache[key] = (refs, value)
        return value

    @staticmethod
    def _per_level(value, stride: int) -> int:
        if value is None:
            return 0
        if isinstance(value, (tuple, list)):
            return int(value[min(_level(stride), len(value) - 1)])
        return int(value)

    def escape_cap_for(self, stride: int) -> int:
        return self._per_level(self.window_escape_cap, stride)

    def escape_tiles_for(self, stride: int) -> int:
        return self._per_level(self.window_escape_tiles, stride) or 64

    def window_plan_direct(self, coords, mask, offsets, transpose=False,
                           stride: int = 1):
        """Window plan of a same-set stride-preserving conv. The second
        plan of a (forward, transpose) pair over a symmetric offset set is
        a relabeling of the first (``transpose_plan``), not a new match."""
        from nerf_downstream_tpu_torch.ops.window_conv import (
            build_plan_direct,
            negation_perm,
            transpose_plan,
        )

        okey = offsets.tobytes()
        key = (id(coords), okey, bool(transpose), "direct")
        plan = self._get(self._window_plans, key)
        if plan is not None:
            return plan
        other = self._get(
            self._window_plans, (id(coords), okey, not transpose, "direct")
        )
        derived = transpose_plan(other, offsets) if other is not None else None
        if derived is not None:
            return self._put(self._window_plans, key, (coords,), derived)
        cap = self.escape_cap_for(stride)
        if cap and negation_perm(offsets) is None:
            cap = 0  # asymmetric subset: strict poison semantics
        plan = build_plan_direct(
            coords, mask, offsets,
            tile=self.window_tile, window=self.window_size,
            blocks=self.window_blocks, transpose=transpose,
            escape_cap=cap, escape_tiles=self.escape_tiles_for(stride),
        )
        return self._put(self._window_plans, key, (coords,), plan)

    def window_plan_cross(self, table_sv, query_sv, offsets, transpose=False,
                          expanding=False):
        """Window plan of a cross-set map: neighbour ranks of
        ``query_sv``'s coords matched in ``table_sv``'s key table.
        ``expanding`` (a stride-2 down conv, several table ranks per query
        row) halves the tile and widens coverage by
        ``window_expand_factor``."""
        from nerf_downstream_tpu_torch.ops.window_conv import build_plan_direct

        key = (id(table_sv.coords), id(query_sv.coords), offsets.tobytes(),
               bool(transpose), "cross")
        plan = self._get(self._window_plans, key)
        if plan is not None:
            return plan
        cross_blocks = self.window_cross_blocks or self.window_blocks
        if expanding:
            tile = max(32, self.window_tile // 2)
            blocks = self.window_expand_factor * cross_blocks
        else:
            tile, blocks = self.window_tile, cross_blocks
        plan = build_plan_direct(
            table_sv.coords, table_sv.mask, offsets,
            tile=tile, window=self.window_size, blocks=blocks,
            transpose=transpose,
            out_coords=query_sv.coords, out_mask=query_sv.mask,
        )
        return self._put(self._window_plans, key,
                         (table_sv.coords, query_sv.coords), plan)

    def window_plan(self, kernel_map, n_in: int, offsets,
                    expansion: int = 1):
        """Window plan of a monotone row kernel map (cached per map).
        ``expansion``: input ranks advanced per output row ((out_stride /
        in_stride)^3 for a map into a coarser set, 1 otherwise)."""
        from nerf_downstream_tpu_torch.ops.window_conv import build_plan

        key = (id(kernel_map), "map")
        plan = self._get(self._window_plans, key)
        if plan is None:
            plan = self._put(self._window_plans, key, (kernel_map,),
                             build_plan(kernel_map, n_in, offsets,
                                        tile=self.window_tile,
                                        window=self.window_size,
                                        expansion=expansion))
        return plan

    def block_layout(self, coords, mask, stride: int):
        """The 4^3 block layout of the level at ``coords`` (cached)."""
        from nerf_downstream_tpu_torch.ops.block_conv import (
            build_block_layout,
        )

        key = (id(coords), stride)
        layout = self._get(self._block_layouts, key)
        if layout is None:
            n = coords.shape[0]
            if self.block_caps is not None:
                cap = self._per_level(self.block_caps, stride)
            else:
                # a shell's occupied blocks thin about stride^2 as the
                # grid coarsens
                cap = max(int(n / (self.block_cap_divisor * stride * stride)),
                          64)
            # never more blocks than rows (the sentinel convention)
            cap = min(cap, n)
            layout = self._put(self._block_layouts, key, (coords,),
                               build_block_layout(
                                   coords, mask, stride, cap,
                                   self.num_batches,
                                   self.grid_extent or 512))
        return layout

    def cell_mask(self, layout):
        from nerf_downstream_tpu_torch.ops.block_resident import cell_mask_of

        key = id(layout)
        m = self._get(self._cell_masks, key)
        if m is None:
            m = self._put(self._cell_masks, key, (layout,),
                          cell_mask_of(layout))
        return m

    def to_block(self, sv: SparseVoxels):
        """Enter the block-resident layout of ``sv``'s level."""
        from nerf_downstream_tpu_torch.ops import block_resident as br

        layout = self.block_layout(sv.coords, sv.mask, sv.stride)
        return br.to_block(sv, layout, self.cell_mask(layout),
                           guard=self.overflow_guard)

    def level_transition(self, bv):
        """(coarse SparseVoxels, coarse layout, coarse cell mask,
        transition) of the stride-2 step down from resident level
        ``bv``."""
        return self.level_transition_for(bv.coords, bv.row_mask, bv.stride,
                                          bv.feats.dtype)

    def level_transition_for(self, coords, row_mask, stride: int, dtype):
        from nerf_downstream_tpu_torch.ops import block_resident as br
        from nerf_downstream_tpu_torch.ops.block_conv import block_grid

        key = (id(coords), stride)
        hit = self._get(self._transitions, key)
        if hit is not None:
            return hit
        fine_sv = SparseVoxels(
            coords=coords, feats=torch.zeros((coords.shape[0], 0), dtype=dtype,
                                             device=coords.device),
            mask=row_mask, stride=stride)
        coarse_sv = self.strided(fine_sv, 2)
        coarse_layout = self.block_layout(coarse_sv.coords, coarse_sv.mask,
                                          coarse_sv.stride)
        gkey = (id(coarse_sv.coords), coarse_sv.stride)
        grid = self._get(self._block_grids, gkey)
        if grid is None:
            grid = self._put(self._block_grids, gkey, (coarse_sv.coords,),
                             block_grid(coarse_layout.block_coords,
                                        coarse_layout.block_mask,
                                        self.num_batches,
                                        self.grid_extent or 512))
        trans = br.build_level_transition(
            self.block_layout(coords, row_mask, stride), coarse_layout,
            grid[0], grid[1], self.num_batches, grid[2])
        return self._put(self._transitions, key, (coords,),
                         (coarse_sv, coarse_layout,
                          self.cell_mask(coarse_layout), trans))

    def strided(self, sv: SparseVoxels, stride: int) -> SparseVoxels:
        """The level ``stride`` times coarser than ``sv`` (cached), capped
        by ``level_cap``; its overflow count feeds ``level_poison``."""
        key = (id(sv.coords), sv.stride, stride)
        out = self._get(self._strided, key)
        if out is None:
            out, lost = kernels.stride_coords_capped(
                sv, stride,
                self.level_cap(sv.stride * stride, sv.capacity, sv.stride))
            self._put(self._strided, key, (sv.coords,), out)
            self._put(self._level_overflow, id(out.coords), (out.coords,),
                      lost)
        return out

    def level_cap(self, stride: int, in_capacity: int | None = None,
                  in_stride: int = 1) -> int | None:
        """Row capacity of the level at absolute tensor stride ``stride``,
        None = uncapped. Absolute ``level_caps`` (indexed by log2 of the
        stride) win; else ``level_cap_decay`` scales the input level's
        capacity ``in_capacity`` (at ``in_stride``) by the decay per
        stride doubling, rounded up to a ``window_tile`` multiple and never
        above ``in_capacity``."""
        if self.level_caps is not None:
            return self._per_level(self.level_caps, stride)
        if self.level_cap_decay is not None and in_capacity is not None:
            doublings = max(0, _level(stride) - _level(in_stride))
            cap = int(in_capacity * self.level_cap_decay ** doublings)
            tile = self.window_tile
            cap = max(tile, ((cap + tile - 1) // tile) * tile)
            return min(cap, in_capacity)
        return None

    def level_poison(self, coords, feats):
        """NaN-poison ``feats`` if the level at ``coords`` lost valid rows
        to its cap (fail loud, never compute on a truncated level)."""
        lost = self._get(self._level_overflow, id(coords))
        if lost is None or not self.overflow_guard:
            return feats
        scale = torch.where(lost > 0, float("nan"), 1.0)
        return feats * scale.to(feats.dtype)

    def _use_grid(self) -> bool:
        return self.method != "search" and self.grid_extent is not None

    def grid_index(self, coords, mask, stride: int):
        key = (id(coords), stride)
        hit = self._get(self._grids, key)
        if hit is None:
            hit = self._put(self._grids, key, (coords,),
                            kernels.build_grid_index(
                                coords, mask, self.num_batches,
                                self.grid_extent, stride))
        return hit

    def kernel_map(self, in_coords, in_mask, out_coords, out_mask,
                   offsets, transpose: bool = False, in_stride: int = 1):
        """Row kernel map int32[K, N_out] (sentinel N_in), cached. A
        transpose map whose forward map exists is that map inverted."""
        okey = offsets.tobytes()
        key = (id(in_coords), id(out_coords), okey, transpose)
        km = self._get(self._kmaps, key)
        if km is not None:
            return km
        fwd = self._get(self._kmaps, (id(out_coords), id(in_coords), okey,
                                      not transpose))
        if fwd is not None:
            km = invert_kernel_map(fwd, out_coords.shape[0])
        elif self._use_grid():
            grid, origin = self.grid_index(in_coords, in_mask, in_stride)
            km = kernels.build_kernel_map_grid(
                grid, origin, self.num_batches, self.grid_extent, in_stride,
                in_coords.shape[0], out_coords, out_mask, offsets, transpose)
        else:
            km = kernels.build_kernel_map(in_coords, in_mask, out_coords,
                                          out_mask, offsets, transpose)
        return self._put(self._kmaps, key, (in_coords, out_coords), km)


def invert_kernel_map(km: torch.Tensor, n_out: int) -> torch.Tensor:
    """Invert a kernel map: fwd[k, o] = i  =>  inv[k, i] = o.

    ``km`` is int32[K, N_fwd_out] with sentinel = the inverse's output
    count; the result is int32[K, n_out] with sentinel = N_fwd_out.
    """
    k, n_fwd_out = km.shape
    dev = km.device
    inv = torch.full((k, n_out + 1), n_fwd_out, dtype=torch.int32,
                     device=dev)
    kk = torch.arange(k, device=dev)[:, None].expand(k, n_fwd_out)
    rows = torch.arange(n_fwd_out, dtype=torch.int32,
                        device=dev)[None, :].expand(k, n_fwd_out)
    inv[kk.reshape(-1), km.clamp(0, n_out).long().reshape(-1)] = \
        rows.reshape(-1)
    # entries pointing at n_out (no neighbour) landed in the extra column
    return inv[:, :n_out]
