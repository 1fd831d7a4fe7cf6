"""Feature selection shared by the datasets (counterpart of
``nerf_downstream_tpu/data/co3d.py::select_features``; the CO3D datasets
themselves are not ported yet, ROADMAP.md Queue 1 item 3)."""

from __future__ import annotations

from typing import List

import numpy as np


def select_features(names: List[str], table: dict) -> np.ndarray:
    """Resolve the reference's eval-string feature selectors safely."""
    cols = []
    for name in names:
        if name not in table:
            raise ValueError(
                f"unknown feature {name!r}; available: {sorted(table)}"
            )
        cols.append(np.asarray(table[name], np.float32))
    return np.concatenate(cols, axis=1)
