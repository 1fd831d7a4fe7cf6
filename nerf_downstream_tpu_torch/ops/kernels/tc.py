"""Launch choices of the gather-matmul and d_w kernels (K2-K6).

bfloat16 calls of K2 (``window_gather_matmul``), of both halves of K3
(``window_bwd``), of K4 (``window_dw``) and of K5
(``window_gather_matmul_bs``) and of K6 (``row_gather_matmul``) run on
the tensor cores
(``window_gather_tc.cuh``, ``window_dw_tc.cuh``); float32 calls stay on
the CUDA-core code. The input type is the only switch. Everything the
kernels need beyond the tensors is chosen here, from the shapes alone, so
that the CPU tests can check it:

- the column tile of the gather-matmul core (``column_tile``): the width
  among 32, 64, 96 and 128 that pads Cout least (the larger on a tie), so
  Cout = 96 is one tile and Cout = 256 two; 32 when a row width is not a
  multiple of 8 (the element-by-element staging has that one tile);
- the split of the G x M terms over blocks (``term_split``): where the
  (rows / 64) x (Cout / tile) blocks would leave SMs idle, the terms go
  in contiguous runs to up to ``MAX_SPLIT`` blocks per output tile, whose
  f32 partials a second kernel adds in a fixed order; K5 takes K2's tile
  and split (``gather_choice``), so its sums are K2's;
- K6's split (``row_choice``): its 2-8 terms are too few to fill the
  SMs at the coarse levels, so the (term, 32-channel chunk) steps go in
  contiguous runs of ``per`` steps to up to ``MAX_SPLIT`` parts per output
  tile, by the rule of ``term_split`` over steps; its f32 partials are
  added in a fixed order into K6's f32 output;
- the d_w tiles (``dw_tiles``), each among 32, 64 and 96 by the same rule,
  and d_w's rows per chunk (``dw_chunk_rows``): each chunk's f32 partial
  is added in a fixed order afterwards, so more chunks mean more blocks
  in flight; enough for about ``DW_TARGET_WARPS`` warps, and at most
  ``DW_MAX_CHUNK_ROWS`` rows each (``dw_choice``; float32 d_w: 64 x 64
  tiles and at most ``F32_DW_MAX_CHUNKS`` chunks of about
  ``F32_DW_CHUNK_ROWS`` rows).
"""

from __future__ import annotations

import dataclasses

import torch

SMS = 132  # streaming multiprocessors of the H100 SXM
TARGET_BLOCKS = 2 * SMS  # blocks that keep every SM busy
MAX_SPLIT = 16  # term runs per output tile: scratch <= 16 x the output
ROW_TILE = 64  # output rows per block of the core
COLUMN_TILES = (32, 64, 96, 128)
DW_TILES = (32, 64, 96)
ALIGN = 16  # bytes: the 16-byte cp.async pieces
DW_TARGET_WARPS = 2048  # warps of the d_w grid: about 16 per SM
DW_MAX_CHUNK_ROWS = 8192
DW_MIN_CHUNK_ROWS = 128
DW_MAX_CHUNKS = 128  # scratch <= 128 x the size of d_w
F32_DW_CHUNK_ROWS = 2048  # CUDA-core d_w: about this many rows a chunk,
F32_DW_MAX_CHUNKS = 16  # in at most this many chunks
TENSOR_CORES = "tensor cores (mma.sync bf16, f32 accumulation)"
CUDA_CORES = "cuda cores (f32 fmaf)"


def vector_ok(c: int, cout: int) -> bool:
    """Whether rows of ``c`` and ``cout`` bf16 values split into whole
    16-byte pieces (else the kernels stage element by element)."""
    return c % 8 == 0 and cout % 8 == 0


def _tile(width: int, tiles) -> int:
    return min(tiles, key=lambda t: (-(-width // t) * t, -t))


def column_tile(c: int, cout: int) -> int:
    """Output columns per block of the gather-matmul core."""
    return _tile(cout, COLUMN_TILES) if vector_ok(c, cout) else 32


def dw_tiles(c: int, cout: int) -> tuple[int, int]:
    """(C tile, Cout tile) per block of the tensor-core d_w kernel."""
    if not vector_ok(c, cout):
        return 32, 32
    return _tile(c, DW_TILES), _tile(cout, DW_TILES)


def dw_chunk_rows(rows: int, c: int, cout: int, n_terms: int) -> int:
    """Rows per d_w partial of the tensor-core d_w kernel over ``rows``
    rows: a multiple of 32 giving at most ``DW_MAX_CHUNKS`` chunks."""
    bc, bo = dw_tiles(c, cout)
    warps = (-(-c // bc) * -(-cout // bo) * (bc // 32) * (bo // 32)
             * max(n_terms, 1))
    chunks = max(-(-rows // DW_MAX_CHUNK_ROWS),
                 int(DW_TARGET_WARPS / warps + 0.5))
    chunks = max(1, min(chunks, DW_MAX_CHUNKS, rows // DW_MIN_CHUNK_ROWS))
    per = -(-rows // chunks)
    return max(32, -(-per // 32) * 32)


def term_split(n_out: int, cout: int, n_terms: int,
               bn: int) -> tuple[int, int]:
    """(parts, terms per part) for ``n_terms`` terms over an
    [n_out, cout] output in column tiles of ``bn``: one part when the
    grid already gives every SM a block, else about ``TARGET_BLOCKS``
    blocks, at most ``MAX_SPLIT`` parts, none of them empty."""
    grid = -(-n_out // ROW_TILE) * -(-cout // bn)
    if grid >= SMS or n_terms <= 1 or grid == 0:
        return 1, max(n_terms, 1)
    want = min(MAX_SPLIT, n_terms, -(-TARGET_BLOCKS // grid))
    per = -(-n_terms // want)
    return -(-n_terms // per), per


@dataclasses.dataclass(frozen=True)
class CoreChoice:
    """How a gather-matmul call runs: ``core`` "tensor" (bf16) or "cuda"
    (float32); for the tensor core, the column tile and the term split."""

    core: str
    column_tile: int = 0
    parts: int = 1
    per: int = 0
    vec: bool = True

    def scratch_numel(self, n_out: int, cout: int) -> int:
        """f32 elements of the split's scratch (0 without a split)."""
        return self.parts * n_out * cout if self.parts > 1 else 0

    def describe(self) -> dict:
        if self.core == "cuda":
            return {"core": CUDA_CORES}
        return {"core": TENSOR_CORES, "column_tile": self.column_tile,
                "split": self.parts, "terms_per_part": self.per}

    def describe_steps(self) -> dict:
        """``describe`` of a K6 choice, whose parts run steps."""
        if self.core == "cuda":
            return self.describe()
        return {"core": TENSOR_CORES, "column_tile": self.column_tile,
                "split": self.parts, "steps_per_part": self.per,
                "staging": "16-byte" if self.vec else "element"}


def gather_choice(dtype, n_out: int, c: int, cout: int,
                  n_terms: int) -> CoreChoice:
    """The core, column tile and term split of a K2 or K5 call (or of
    K3's d_feats half) on ``dtype`` inputs with [n_out, cout] output."""
    if dtype != torch.bfloat16:
        return CoreChoice("cuda")
    bn = column_tile(c, cout)
    parts, per = term_split(n_out, cout, n_terms, bn)
    return CoreChoice("tensor", bn, parts, per)


CHUNK = 32  # input channels per step of the tensor-core core


def row_choice(dtype, n_out: int, c: int, cout: int, n_terms: int,
               aligned: bool = True) -> CoreChoice:
    """The core, column tile and step split of a K6 call on ``dtype``
    inputs with [n_out, cout] output over ``n_terms`` kernel offsets:
    bf16 on the tensor cores, its ``n_terms x ceil(c / CHUNK)`` (term,
    chunk) steps split into ``parts`` runs of ``per`` steps (``term_split``
    over steps); the 16-byte staging where ``vector_ok`` and ``aligned``
    (both operands on 16-byte boundaries), else element staging with the
    32-column tile; float32 on the CUDA cores."""
    if dtype != torch.bfloat16:
        return CoreChoice("cuda")
    vec = vector_ok(c, cout) and aligned
    bn = column_tile(c, cout) if vec else 32
    steps = n_terms * -(-c // CHUNK)
    if c > 32 * CHUNK:  # the split marks a term's chunks in one 32-bit word
        parts, per = 1, steps
    else:
        parts, per = term_split(n_out, cout, steps, bn)
    return CoreChoice("tensor", bn, parts, per, vec)


@dataclasses.dataclass(frozen=True)
class DwChoice:
    """How a d_w call (K4, or K3's d_w half) runs: ``core`` "tensor"
    (bf16) or "cuda" (float32), its (C tile, Cout tile) and its rows per
    f32 partial."""

    core: str
    tiles: tuple[int, int]
    chunk_rows: int

    def chunks(self, rows: int) -> int:
        return -(-rows // self.chunk_rows)

    def describe(self, rows: int) -> dict:
        return {"core": TENSOR_CORES if self.core == "tensor" else CUDA_CORES,
                "tiles": list(self.tiles), "chunk_rows": self.chunk_rows,
                "row_chunks": self.chunks(rows)}


def dw_choice(dtype, rows: int, c: int, cout: int,
              n_terms: int) -> DwChoice:
    """The core, tiles and row chunks of a d_w call over ``rows`` rows on
    ``dtype`` inputs: bf16 on the tensor cores (``dw_tiles``,
    ``dw_chunk_rows``); float32 on the CUDA cores in 64 x 64 tiles, about
    ``F32_DW_CHUNK_ROWS`` rows a chunk (a multiple of 64), at most
    ``F32_DW_MAX_CHUNKS`` chunks."""
    if dtype == torch.bfloat16:
        return DwChoice("tensor", dw_tiles(c, cout),
                        dw_chunk_rows(rows, c, cout, n_terms))
    chunks = max(1, min(F32_DW_MAX_CHUNKS, -(-rows // F32_DW_CHUNK_ROWS)))
    per = -(-rows // chunks)
    return DwChoice("cuda", (64, 64), max(64, -(-per // 64) * 64))


def aligned(*tensors) -> bool:
    """Whether every tensor starts on a 16-byte boundary."""
    return all(t.data_ptr() % ALIGN == 0 for t in tensors)


def check_aligned(name: str, *tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary, as the
    16-byte copies of the vector staging need."""
    for t in tensors:
        if not aligned(t):
            raise ValueError(f"{name}: a tensor starts at {t.data_ptr():#x},"
                             f" not on a {ALIGN}-byte boundary")
