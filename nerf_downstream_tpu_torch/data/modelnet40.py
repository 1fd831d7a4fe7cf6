"""ModelNet40 point-cloud classification from the HDF5 release
(counterpart of ``nerf_downstream_tpu/data/modelnet40.py``, the port's own
copy): 2,048-point clouds and their labels from ``ply_data_train*.h5``
(phase "train") or ``ply_data_test*.h5`` (phases "val" and "test"), in
sorted file order. A sample is the first ``num_points`` points through
the phase's transform pipeline (train: ``train_transformations``;
otherwise ``eval_transformations``), with coordinates in voxels
(``xyz / voxel_size``), the points themselves as its 3 features and its
label as an int32 array of shape (1,), as the reference's.

``arrays = (data [N, P, 3], label [N] or [N, 1])``, or a mapping of the
file phase ("train" or "test") to such a pair (so that one gin binding,
``ModelNet40H5Dataset.arrays = @name()``, serves every phase), gives the
clouds directly instead of reading files (``data_root`` is then not
read); each sample is made by the same ``__getitem__``. ``download`` is accepted and
only logs: nothing is fetched.
"""

from __future__ import annotations

import glob
import logging
import os

import numpy as np

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data import transforms as T


@cfg.configurable
class ModelNet40H5Dataset:
    def __init__(
        self,
        phase: str,
        data_root: str = "modelnet40h5",
        train_transformations=("CoordinateUniformTranslation",),
        eval_transformations=(),
        num_points: int = 2048,
        voxel_size: float = 0.05,
        download: bool = False,
        arrays=None,
    ):
        phase = "test" if phase in ("val", "test") else "train"
        if arrays is None:
            if download and not os.path.exists(data_root):
                logging.warning(
                    "ModelNet40 download requested, but nothing is fetched; "
                    "place ply_data_*.h5 under %s", data_root)
            self.data, self.label = self.load(data_root, phase)
        else:
            if isinstance(arrays, dict):
                arrays = arrays[phase]
            self.data = np.asarray(arrays[0], np.float32)
            self.label = np.asarray(arrays[1], np.int64)
        names = (train_transformations if phase == "train"
                 else eval_transformations)
        self.transformations = T.build(names, device_ok=(phase == "train"))
        self.phase = phase
        self.voxel_size = voxel_size
        self.num_points = num_points

    @staticmethod
    def load(data_root: str, phase: str):
        """(points f32 [N, P, 3], labels int64 [N, 1]) of the phase's
        files under ``data_root``."""
        import h5py

        if not os.path.exists(data_root):
            raise FileNotFoundError(f"{data_root} does not exist")
        files = sorted(glob.glob(os.path.join(data_root,
                                              f"ply_data_{phase}*.h5")))
        if not files:
            raise FileNotFoundError(f"no ply_data_{phase}*.h5 under "
                                    f"{data_root}")
        data, labels = [], []
        for name in files:
            with h5py.File(name, "r") as f:
                data.append(f["data"][:].astype(np.float32))
                labels.append(f["label"][:].astype(np.int64))
        return np.concatenate(data, 0), np.concatenate(labels, 0)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, i: int) -> dict:
        xyz = self.data[i]
        if len(xyz) > self.num_points > 0:
            xyz = xyz[: self.num_points]
        if self.transformations is not None:
            xyz, _, _ = self.transformations(xyz, None, None)
        xyz = xyz.astype(np.float32)
        return {
            "coordinates": xyz / self.voxel_size,
            "features": xyz,
            "labels": np.asarray(self.label[i]).reshape(-1).astype(np.int32),
        }


# the reference's alias
ModelNet40H5 = ModelNet40H5Dataset
