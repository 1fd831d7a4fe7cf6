"""Joint 2D+3D PeRFception-CO3D dataset for the fused ensemble
(counterpart of ``nerf_downstream_tpu/data/joint.py``, numpy and PIL
only).

Each scene's Plenoxel voxels (``plenoxel_co3d_<inst>/data.npz``, read as
``Co3DDatasetBase`` reads them) come with one of its rendered frames
(``<frames_root>/<class>/<inst>/fgbg/``, the ``frame_index``-th file in
sorted order, resized with PIL's default filter to ``image_size`` square,
RGB in [0, 1]), or a black frame where the scene has none; batches carry
both the images and the fixed-capacity rows under one label.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data.co3d import Co3DDatasetBase
from nerf_downstream_tpu_torch.data.utils import collate_mink


@cfg.configurable("JointCo3DDataset")
class JointCo3DDataset(Co3DDatasetBase):
    """``Co3DDatasetBase``'s items, each with ``image`` float32[S, S, 3]."""

    def __init__(self, phase: str, data_root: str = "co3d_3d/datasets/co3d",
                 frames_root: str = "co3d_2d/datasets/perfception",
                 image_size: int = 224, frame_index: int = 0, **kwargs):
        super().__init__(phase, data_root, **kwargs)
        self.frames_root = frames_root
        self.image_size = image_size
        self.frame_index = frame_index

    def _load_frame(self, label_name: str, inst_id: str) -> np.ndarray:
        from PIL import Image

        fdir = os.path.join(self.frames_root, label_name, inst_id, "fgbg")
        files = sorted(os.listdir(fdir)) if os.path.isdir(fdir) else []
        if not files:
            return np.zeros((self.image_size, self.image_size, 3),
                            np.float32)
        name = files[self.frame_index % len(files)]
        img = Image.open(os.path.join(fdir, name)).convert("RGB")
        img = img.resize((self.image_size, self.image_size))
        return np.asarray(img, np.float32) / 255.0

    def __getitem__(self, index: int) -> dict:
        item = super().__getitem__(index)
        label_name, inst_id = self.files[index]
        item["image"] = self._load_frame(label_name, inst_id)
        return item


def collate_joint(samples: List[dict], capacity: int | None = None) -> dict:
    """``collate_mink``'s batch of the rows, and ``images`` [B, S, S, 3]."""
    batch = collate_mink(samples, capacity=capacity)
    batch["images"] = np.stack([s["image"] for s in samples]).astype(
        np.float32)
    return batch
