"""Weight-sparse convolution helpers (counterpart of
``nerf_downstream_tpu/ops/weight_sparse.py``; pure numpy, copied rather
than imported so the port needs nothing of the JAX package).

A pruned checkpoint is used two ways:

- offset level: ``valid_offsets_from_weights`` finds the kernel offsets
  whose matrix kept any weight, and a conv then runs over that subset
  alone (``zaxis_offsets`` is the fixed z-column subset of ZAXIS mode);
  ``pad_offset_groups`` pads a subset whose (dx, dy) groups differ in size
  with zero-weight repeats, so the windowed kernels can take it;
- block level: ``block_live_from_weights`` marks the live (Cin-block,
  Cout-block) tiles of every offset's matrix, and the block-sparse
  windowed forward (K5) skips the dead ones.
"""

from __future__ import annotations

import numpy as np


def valid_offsets_from_weights(weights: np.ndarray, tol: float = 0.0):
    """Offsets whose kernel matrix has any surviving weight: [K, Ci, Co] ->
    tuple of live offset indices."""
    w = np.asarray(weights)
    live = np.abs(w).max(axis=(1, 2)) > tol
    return tuple(int(i) for i in np.nonzero(live)[0])


def zaxis_offsets(offsets: np.ndarray):
    """Offsets with dx == dy == 0 (indices 4, 13, 22 for k = 3)."""
    offs = np.asarray(offsets)
    sel = (offs[:, 0] == 0) & (offs[:, 1] == 0)
    return tuple(int(i) for i in np.nonzero(sel)[0])


def subset_offsets(offsets: np.ndarray, valid: tuple):
    return np.asarray(offsets)[list(valid)]


def sparsity_stats(weights: np.ndarray) -> dict:
    w = np.asarray(weights)
    total = w.size
    zeros = int((w == 0).sum())
    live = valid_offsets_from_weights(w)
    return {
        "total": total,
        "zeros": zeros,
        "density": 1 - zeros / max(total, 1),
        "live_offsets": len(live),
        "kernel_volume": w.shape[0],
    }


BLOCK = 128


def block_live_from_weights(
    weights: np.ndarray, block: int = BLOCK, tol: float = 0.0
) -> np.ndarray:
    """Per-offset block liveness: [K, Ci, Co] -> bool[K, nbi, nbo] where
    block (bi, bo) is live iff any |w| in its (<=block x <=block) tile
    exceeds ``tol``. Edge blocks (Ci/Co not multiples of ``block``) are
    clamped, not padded."""
    w = np.asarray(weights)
    k, ci, co = w.shape
    nbi = -(-ci // block)
    nbo = -(-co // block)
    out = np.zeros((k, nbi, nbo), bool)
    for bi in range(nbi):
        for bo in range(nbo):
            tile = w[
                :, bi * block:(bi + 1) * block, bo * block:(bo + 1) * block
            ]
            out[:, bi, bo] = np.abs(tile).max(axis=(1, 2)) > tol
    return out


def block_live_savings(live: np.ndarray) -> float:
    """Fraction of weight blocks the block-sparse forward skips (0 = fully
    dense)."""
    lv = np.asarray(live)
    return 1.0 - lv.sum() / max(lv.size, 1)


def pad_offset_groups(offsets: np.ndarray, valid: tuple):
    """Pad an offset subset's (dx, dy) groups to one size.

    A padded slot repeats its group's first live offset and maps to
    weight row -1; the conv zeroes those weight slots, so the repeated
    matches add nothing.

    Returns (padded offsets [K'], weight_rows int64[K'] — original offset
    index or -1 for padding).
    """
    offs = np.asarray(offsets)
    groups: dict = {}
    for i in valid:
        dx, dy, _dz = offs[int(i)]
        groups.setdefault((int(dx), int(dy)), []).append(int(i))
    m = max(len(v) for v in groups.values())
    out_offs, rows = [], []
    for idxs in groups.values():
        for i in idxs:
            out_offs.append(offs[i])
            rows.append(i)
        for _ in range(m - len(idxs)):
            out_offs.append(offs[idxs[0]])
            rows.append(-1)
    return np.asarray(out_offs), np.asarray(rows, np.int64)
