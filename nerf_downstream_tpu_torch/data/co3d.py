"""PeRFception-CO3D Plenoxel classification datasets (counterpart of
``nerf_downstream_tpu/data/co3d.py``, the port's own copy, numpy only).

``Co3DDatasetBase`` reads one ``plenoxel_co3d_<id>`` scene per row of
``filelist/{train,test}.txt`` (``<class> <id>``; the val phase reads the
test list): its voxel coordinates, and density plus the 27 SH
coefficients behind three normalised position channels, through the
phase's transform pipeline, then the features the config names
(``xyzs``, ``density``, ``sh``, ``ones``; ``select_features``). The label
is the class's index in ``CLASSES`` (51 classes). Two quirks of the
reference are kept, so features match its checkpoints:

- each row is centred by its *own* coordinate mean (``mean(axis=1)``, the
  reference's ``mean(dim=1)``), not by the scene's centroid, before the
  scale to the unit sphere;
- ``downsample_stride`` and ``downsample_mode`` are dead unless
  ``apply_downsample`` is set: the reference's ``__getitem__`` never calls
  ``downsample`` either.

The file lists are read from ``filelist_dir`` (default ``filelist``,
relative to the working directory, as the reference does), else from
``<data_root>/filelist``.
"""

from __future__ import annotations

import logging
import os
from typing import List

import numpy as np

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data import plenoxel
from nerf_downstream_tpu_torch.data import transforms as T

CLASSES = [
    "apple", "backpack", "ball", "banana", "baseballbat", "baseballglove",
    "bench", "bicycle", "book", "bottle", "bowl", "broccoli", "cake", "car",
    "carrot", "cellphone", "chair", "couch", "cup", "donut", "frisbee",
    "hairdryer", "handbag", "hotdog", "hydrant", "keyboard", "kite", "laptop",
    "microwave", "motorcycle", "mouse", "orange", "parkingmeter", "pizza",
    "plant", "remote", "sandwich", "skateboard", "stopsign", "suitcase",
    "teddybear", "toaster", "toilet", "toybus", "toyplane", "toytrain",
    "toytruck", "tv", "umbrella", "vase", "wineglass",
]
CLASSES_IDX = {k: v for v, k in enumerate(CLASSES)}


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


@cfg.configurable
class Co3DDatasetBase:
    DATA_PATH_FILE = {
        "train": "train.txt",
        "val": "test.txt",
        "test": "test.txt",
    }

    def __init__(
        self,
        phase: str,
        data_root: str = "co3d_3d/datasets/co3d",
        train_transformations=(),
        eval_transformations=(),
        downsample_mode: int = 1,
        downsample_stride: int = 2,
        num_points: int = -1,
        features: List[str] = ("sh",),
        filelist_dir: str | None = None,
        apply_downsample: bool = False,
    ):
        self.apply_downsample = apply_downsample
        phase = "test" if phase in ("val", "test") else "train"
        names = train_transformations if phase == "train" else eval_transformations
        self.transformations = T.build(names, device_ok=(phase == "train"))
        self.phase = phase
        self.data_root = data_root
        self.num_points = num_points
        self.features = list(features)
        self.downsample_mode = downsample_mode
        self.downsample_stride = downsample_stride
        self.CLASS_LABELS = CLASSES
        self.NUM_CLASSES = len(CLASSES)

        path = os.path.join(filelist_dir or "filelist", f"{phase}.txt")
        if not os.path.exists(path):
            path = os.path.join(data_root, "filelist", f"{phase}.txt")
        with open(path) as f:
            self.files = [l.strip("\n").split()[:2] for l in f if l.strip()]
        logging.info(
            f"{type(self).__name__}(phase={phase}, total size="
            f"{len(self.files)}, num_classes={self.NUM_CLASSES}, "
            f"downsample stride={self.downsample_stride})"
        )

    def __len__(self):
        return len(self.files)

    def load_data(self, inst_id: str) -> dict:
        return plenoxel.load_scene(
            os.path.join(self.data_root, f"plenoxel_co3d_{inst_id}")
        )

    def downsample(self, coords: np.ndarray, feats: np.ndarray):
        if self.downsample_stride <= 1:
            return coords, feats
        if self.downsample_mode == 0:
            return plenoxel.avg_downsample(coords, feats, self.downsample_stride)
        if self.downsample_mode == 1:
            c, (f,) = plenoxel.stride_downsample(
                coords, [feats], self.downsample_stride
            )
            return c, f
        raise ValueError(f"Downsample mode {self.downsample_mode} is invalid.")

    def __getitem__(self, index: int) -> dict:
        label, inst_id = self.files[index]
        label = CLASSES_IDX[label]
        data = self.load_data(inst_id)
        coords = np.asarray(data["coords"], np.float32)
        density_sh = np.concatenate([data["density"], data["sh"]], axis=1)
        if self.apply_downsample:
            coords, density_sh = self.downsample(coords, density_sh)

        # per-row centring (see the module docstring), then the unit sphere
        xyzs = coords - coords.mean(axis=1, keepdims=True)
        max_norm = np.linalg.norm(xyzs, axis=1).max() or 1.0
        xyzs = xyzs / max_norm
        raw = np.concatenate([xyzs, density_sh], axis=1).astype(np.float32)

        if self.transformations is not None:
            coords, raw, _ = self.transformations(coords, raw, None)

        table = {
            "xyzs": raw[:, :3],
            "density": raw[:, 3:4],
            "sh": raw[:, 4:],
            "ones": np.ones_like(raw[:, 3:4]),
        }
        feats = select_features(self.features, table)
        return {
            "coordinates": np.asarray(coords, np.float32),
            "features": feats,
            "xyzs": table["xyzs"],
            "labels": np.array([label], np.int32),
            "metadata": {"file": inst_id},
        }


class Co3DDataset(Co3DDatasetBase):
    DATA_PATH_FILE = {
        "train": "co3d_train.txt",
        "trainval": "co3d_trainval.txt",
        "val": "co3d_val.txt",
        "test": "co3d_test.txt",
    }
    CLASS_FILE = "co3d_classes.txt"


class Co3D10pDataset(Co3DDatasetBase):
    DATA_PATH_FILE = {
        "train": "co3d_10p_train.txt",
        "trainval": "co3d_10p_trainval.txt",
        "val": "co3d_10p_val.txt",
        "test": "co3d_10p_test.txt",
    }
    CLASS_FILE = "co3d_10p_classes.txt"
