"""ScanNet datasets: raw meshes and PeRFception-ScanNet Plenoxel grids
(counterpart of ``nerf_downstream_tpu/data/scannet.py``).

- ``ScannetDataset``: ScanNet v2 PLY point clouds, pre-downsampled at half
  a voxel (``sparse_quantize``: the first point of each cell, a cell's
  conflicting labels become ``ignore_label``), coordinates in voxel
  units, the 20-class nyu40 remap, colours as features
  (reference :149-308).
- ``PlenoxelScannetDataset``: per-voxel labels + distances to the nearest
  labeled GT point; ``dists > valid_thres`` voxels become the void class,
  optional ``ignore_thres`` row filtering, per-scene metric rescale via the
  pickled ``scene_scales.data`` (reference :449-660).
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import List, Optional

import numpy as np

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data import plenoxel
from nerf_downstream_tpu_torch.data import transforms as T
from nerf_downstream_tpu_torch.data.co3d import select_features
from nerf_downstream_tpu_torch.data.ply import load_ply

# The 20 evaluated ScanNet benchmark classes (reference scannet.py tables)
CLASS_LABELS = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)
VALID_CLASS_IDS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)
# instance classes exclude wall/floor
CLASS_LABELS_INSTANCE = CLASS_LABELS[2:]
VALID_CLASS_IDS_INSTANCE = VALID_CLASS_IDS[2:]

SCANNET_COLOR_MAP = {}  # populated on demand for visualization


def build_label_map(num_labels: int, valid_ids, ignore_label: int,
                    void_label: Optional[int] = None) -> dict:
    """nyu40 id -> contiguous train id; unevaluated ids -> ignore_label;
    optional void id appended as the last class (reference :517-528)."""
    ignore_ids = set(range(num_labels)) - set(valid_ids)
    label_map, n_used = {}, 0
    for l in range(num_labels):
        if l in ignore_ids:
            label_map[l] = ignore_label
        else:
            label_map[l] = n_used
            n_used += 1
    label_map[ignore_label] = ignore_label
    if void_label is not None and void_label != ignore_label:
        label_map[void_label] = n_used
    return label_map


def remap_labels(labels: np.ndarray, label_map: dict,
                 ignore_label: int) -> np.ndarray:
    lut_size = max(max(label_map) + 1, 0) + 1
    lut = np.full(lut_size, ignore_label, np.int32)
    for k, v in label_map.items():
        if k >= 0:
            lut[k] = v
    labels = np.asarray(labels).astype(np.int64)
    out = np.where(
        (labels >= 0) & (labels < lut_size), lut[np.clip(labels, 0, lut_size - 1)],
        ignore_label,
    )
    # negative special labels (e.g. void_label = -1, scannet_plenoxel_void.gin)
    for k, v in label_map.items():
        if k < 0:
            out = np.where(labels == k, v, out)
    return out.astype(np.int32)


def sparse_quantize(xyz: np.ndarray, qsize: float, labels=None,
                    ignore_label: int = -100):
    """Grid dedup keeping first point per cell; conflicting labels in a cell
    become ignore_label (ME.utils.sparse_quantize semantics)."""
    cell = np.floor(xyz / qsize).astype(np.int64)
    key = (cell[:, 0] << 42) ^ (cell[:, 1] << 21) ^ cell[:, 2]
    _, first_idx, inv = np.unique(key, return_index=True, return_inverse=True)
    out_labels = None
    if labels is not None:
        lmin = np.full(len(first_idx), np.iinfo(np.int64).max)
        lmax = np.full(len(first_idx), np.iinfo(np.int64).min)
        np.minimum.at(lmin, inv, labels)
        np.maximum.at(lmax, inv, labels)
        out_labels = np.where(lmin == lmax, lmin, ignore_label).astype(np.int32)
    return first_idx, out_labels


@cfg.configurable
class ScannetDataset:
    NUM_LABELS = 41
    DATA_PATH_FILE = {
        "train": "scannetv2_train.txt",
        "val": "scannetv2_val.txt",
        "test": "scannetv2_test.txt",
    }
    CLASS_LABELS = CLASS_LABELS
    VALID_CLASS_IDS = VALID_CLASS_IDS

    def __init__(
        self,
        phase: str,
        data_root: str = "datasets/scannet",
        downsample_voxel_size=None,
        voxel_size: float = 0.02,
        train_transformations=(
            "ChromaticTranslation", "ChromaticJitter", "CoordinateDropout",
            "RandomHorizontalFlip", "RandomAffine", "RandomTranslation",
            "NormalizeColor",
        ),
        eval_transformations=("NormalizeColor",),
        ignore_label: int = -100,
        features: List[str] = ("colors",),
    ):
        self.phase = phase
        self.data_root = data_root
        self.ignore_label = ignore_label
        names = train_transformations if phase == "train" else eval_transformations
        self.transformations = T.build(names, device_ok=(phase == "train"))
        with open(os.path.join(data_root, self.DATA_PATH_FILE[phase])) as f:
            self.pc_files = [l.rstrip("\n") for l in f if l.strip()]
        self.downsample_voxel_size = (
            voxel_size / 2 if downsample_voxel_size is None
            else downsample_voxel_size
        )
        self.voxel_size = voxel_size
        self.label_map = build_label_map(
            self.NUM_LABELS, self.VALID_CLASS_IDS, ignore_label
        )
        self.features = list(features)
        logging.info(
            f"{type(self).__name__}(phase={phase}, total size="
            f"{len(self.pc_files)}, voxel_size={voxel_size})"
        )

    def __len__(self):
        return len(self.pc_files)

    def __getitem__(self, i: int) -> dict:
        xyzs, colors, labels, instances = load_ply(
            os.path.join(self.data_root, self.pc_files[i]),
            load_label=True, load_instance=True,
        )
        if self.downsample_voxel_size > 0:
            keep, qlabels = sparse_quantize(
                xyzs, self.downsample_voxel_size, labels, self.ignore_label
            )
            xyzs = xyzs[keep] / self.voxel_size
            colors = colors[keep]
            labels = qlabels
            instances = instances[keep]
        else:
            xyzs = xyzs / self.voxel_size
        xyzs, colors, labels = self.transformations(xyzs, colors, labels)
        labels = remap_labels(labels, self.label_map, self.ignore_label)
        feats = select_features(
            self.features, {"colors": colors, "xyzs": xyzs}
        )
        return {
            "coordinates": xyzs.astype(np.float32),
            "features": feats,
            "labels": labels,
            "colors": colors,
            "dataset": "scannet",
        }


@cfg.configurable
class PlenoxelScannetDataset:
    NUM_LABELS = 41
    DATA_PATH_FILE = {
        "train": "scannet_256_train.txt",
        "val": "scannet_256_val.txt",
        "test": "scannet_256_val.txt",
    }
    CLASS_LABELS = CLASS_LABELS
    VALID_CLASS_IDS = VALID_CLASS_IDS

    def __init__(
        self,
        phase: str,
        data_root: str = "co3d_3d/datasets/perfception-scannet",
        train_transformations=(),
        eval_transformations=(),
        downsample_mode: int = 1,
        downsample_stride: int = 2,
        voxel_size: float = 0.02,
        num_points: int = -1,
        features: List[str] = ("sh",),
        ignore_label: int = -100,
        void_label: Optional[int] = None,
        valid_thres: float = 0.05,
        ignore_thres: Optional[float] = None,
    ):
        phase = "test" if phase in ("val", "test") else "train"
        names = train_transformations if phase == "train" else eval_transformations
        self.transformations = T.build(names, device_ok=(phase == "train"))
        self.phase = phase
        self.data_root = data_root
        self.num_points = num_points
        self.features = list(features)
        self.voxel_size = voxel_size
        self.ignore_label = ignore_label
        self.void_label = void_label if void_label is not None else ignore_label
        self.valid_thres = valid_thres
        self.ignore_thres = ignore_thres
        self.downsample_mode = downsample_mode
        self.downsample_stride = downsample_stride

        split_dir = os.path.join(os.path.dirname(data_root), "split")
        with open(os.path.join(split_dir, self.DATA_PATH_FILE[phase])) as f:
            self.files = [
                l.strip("\n") for l in f if l.strip() and not l.startswith("#")
            ]
        self.label_map = build_label_map(
            self.NUM_LABELS, self.VALID_CLASS_IDS, ignore_label, void_label
        )
        scales_path = os.path.join(split_dir, "scene_scales.data")
        if os.path.exists(scales_path):
            with open(scales_path, "rb") as f:
                self.scene_scales = pickle.load(f)
        else:
            logging.warning(f"{scales_path} missing; using scale 1.0")
            self.scene_scales = {}
        logging.info(
            f"{type(self).__name__}(phase={phase}, total size={len(self.files)},"
            f" num_classes={len(self.CLASS_LABELS)},"
            f" downsample stride={self.downsample_stride})"
        )

    def __len__(self):
        return len(self.files)

    def load_data(self, inst_id: str) -> dict:
        data = plenoxel.load_npz(
            os.path.join(self.data_root, f"plenoxel_torch_{inst_id}", "data.npz")
        )
        labels = np.asarray(data["labels"]).reshape(-1).astype(np.int32)
        dists = np.asarray(data["dists"], np.float32).reshape(-1)
        # voxels too far from any labeled GT point become void (:572-573)
        labels = np.where(dists > self.valid_thres, self.void_label, labels)
        if self.ignore_thres is not None and self.ignore_thres > 0:
            valid = dists < self.ignore_thres
            for k in ("coords", "density", "sh"):
                data[k] = data[k][valid]
            labels = labels[valid]
            dists = dists[valid]
        data["labels"] = labels
        data["dists"] = dists
        return data

    def downsample(self, coords, feats):
        if self.downsample_stride <= 1:
            return coords, feats
        if self.downsample_mode == 0:
            c, f = plenoxel.avg_downsample(coords, feats, self.downsample_stride)
            return c / 2, f
        if self.downsample_mode == 1:
            c, (f,) = plenoxel.stride_downsample(
                coords.astype(np.int64), [feats], self.downsample_stride
            )
            return c.astype(np.float32), f
        raise ValueError(f"Downsample mode {self.downsample_mode} is invalid.")

    def __getitem__(self, index: int) -> dict:
        inst_id = self.files[index]
        data = self.load_data(inst_id)
        coords = np.asarray(data["coords"], np.float32)
        density = data["density"].copy()
        if len(self.features) > 1:
            density = density / (np.abs(density).max() + 1e-5)
        stacked = np.concatenate(
            [
                data["dists"][:, None], density, data["sh"],
                data["labels"][:, None].astype(np.float32),
            ],
            axis=1,
        )
        coords, stacked = self.downsample(coords, stacked)
        reso = np.asarray(data["reso"], np.float32)
        norm_coords = coords / reso * 2 - 1.0
        scene_scale = self.scene_scales.get(inst_id, 1.0)
        xyzs = (norm_coords / scene_scale) / self.voxel_size
        labels = stacked[:, -1].astype(np.int32)
        raw = np.concatenate([xyzs, stacked[:, :-1]], axis=1).astype(np.float32)

        if self.transformations is not None:
            xyzs, raw, labels = self.transformations(xyzs, raw, labels)

        table = {
            "xyzs": raw[:, :3],
            "dists": raw[:, 3:4],
            "density": raw[:, 4:5],
            "sh": raw[:, 5:],
            "ones": np.ones_like(raw[:, 4:5]),
        }
        feats = select_features(self.features, table)
        labels = remap_labels(labels, self.label_map, self.ignore_label)
        return {
            "coordinates": np.asarray(xyzs, np.float32),
            "features": feats,
            "xyzs": np.asarray(table["xyzs"], np.float32),
            "labels": labels,
            "dists": table["dists"],
            "metadata": {"file": inst_id},
        }
