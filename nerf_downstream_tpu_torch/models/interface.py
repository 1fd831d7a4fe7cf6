"""Model input interface (counterpart of
``nerf_downstream_tpu/models/interface.py``): ``process_input(batch)``
wraps a collated batch's rows into a :class:`PointField`.
"""

from __future__ import annotations

from nerf_downstream_tpu_torch.sparse.types import PointField


def process_input(batch: dict) -> PointField:
    """batch: {"coordinates": [N, 4], "features": [N, C], "mask": [N]
    bool}, tensors on the model's device -> PointField."""
    return PointField(coords=batch["coordinates"], feats=batch["features"],
                      mask=batch["mask"])
