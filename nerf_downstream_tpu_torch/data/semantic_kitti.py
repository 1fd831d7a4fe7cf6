"""SemanticKITTI LiDAR segmentation (counterpart of
``nerf_downstream_tpu/data/semantic_kitti.py``): velodyne ``.bin`` scans
with their ``.label`` files, the 19-class remap that folds each moving
class onto its static class, a half-voxel ``sparse_quantize``
downsample, ``xyzi`` features, and ``save_prediction``, which writes the
predicted labels back in the raw ids (``uint32``) for the benchmark
server.

The tree is the benchmark's: ``<data_root>/dataset/sequences/<seq>/
velodyne/<frame>.bin`` (float32 x, y, z, intensity) and ``labels/
<frame>.label`` (uint32, the semantic id in the low 16 bits). Sequences
00-07, 09 and 10 train, 08 validates, 11-21 are the test set.
"""

from __future__ import annotations

import logging
import os
from typing import List

import numpy as np

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data import transforms as T
from nerf_downstream_tpu_torch.data.co3d import select_features
from nerf_downstream_tpu_torch.data.scannet import sparse_quantize

CLASS_LABELS = (
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
)

LABEL_NAME_MAPPING = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
    15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
    30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
    44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building",
    51: "fence", 52: "other-structure", 60: "lane-marking", 70: "vegetation",
    71: "trunk", 72: "terrain", 80: "pole", 81: "traffic-sign",
    99: "other-object", 252: "moving-car", 253: "moving-bicyclist",
    254: "moving-person", 255: "moving-motorcyclist", 256: "moving-on-rails",
    257: "moving-bus", 258: "moving-truck", 259: "moving-other-vehicle",
}

PHASE_SEQUENCES = {
    "train": ("00", "01", "02", "03", "04", "05", "06", "07", "09", "10"),
    "trainval": ("00", "01", "02", "03", "04", "05", "06", "07", "08", "09",
                 "10"),
    "val": ("08",),
    "small_val": ("08",),
    "test": ("11", "12", "13", "14", "15", "16", "17", "18", "19", "20",
             "21"),
}


def build_kitti_label_maps(ignore_label: int):
    """(raw id -> train id, train id -> raw id), both int64[260]. A
    moving class takes its static class's train id; every id outside the
    19 classes maps to ``ignore_label``."""
    label_map = np.full(260, ignore_label, np.int64)
    label_inv_map = np.zeros(260, np.int64)
    name_to_train = {}
    cnt = 0
    for label_id, name in LABEL_NAME_MAPPING.items():
        if label_id > 250:
            base = name.replace("moving-", "")
            if base in CLASS_LABELS:
                label_map[label_id] = name_to_train[base]
        elif label_id == 0:
            label_map[label_id] = ignore_label
        elif name in CLASS_LABELS:
            label_map[label_id] = cnt
            name_to_train[name] = cnt
            label_inv_map[cnt] = label_id
            cnt += 1
    return label_map, label_inv_map


@cfg.configurable
class SemanticKITTIDataset:
    NUM_LABELS = 19
    CLASS_LABELS = CLASS_LABELS

    def __init__(
        self,
        phase: str,
        data_root: str = "datasets/semantic-kitti/",
        downsample_voxel_size=None,
        voxel_size: float = 0.05,
        train_transformations=(
            "CoordinateDropout", "RandomHorizontalFlip", "RandomAffine",
            "RandomTranslation",
        ),
        eval_transformations=(),
        ignore_label: int = -100,
        features: List[str] = ("xyzi",),
    ):
        self.data_root = data_root
        self.phase = phase
        self.ignore_label = ignore_label
        names = (train_transformations if phase == "train"
                 else eval_transformations)
        self.transformations = T.build(names, device_ok=(phase == "train"))
        self.pc_files = []
        for seq in PHASE_SEQUENCES.get(phase, PHASE_SEQUENCES["val"]):
            seq_dir = os.path.join(data_root, "dataset/sequences", seq,
                                   "velodyne")
            self.pc_files += [os.path.join(seq, "velodyne", x)
                              for x in sorted(os.listdir(seq_dir))]
        if phase == "small_val":
            self.pc_files = self.pc_files[::10]
        self.downsample_voxel_size = (
            voxel_size / 2 if downsample_voxel_size is None
            else downsample_voxel_size
        )
        self.voxel_size = voxel_size
        self.features = list(features)
        self.label_map, self.label_inv_map = build_kitti_label_maps(
            ignore_label)
        logging.info(
            f"{type(self).__name__}(phase={phase}, total size="
            f"{len(self.pc_files)}, voxel_size={voxel_size})"
        )

    def __len__(self):
        return len(self.pc_files)

    def __getitem__(self, i: int) -> dict:
        path = os.path.join(self.data_root, "dataset/sequences",
                            self.pc_files[i])
        xyzi = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        xyzs = xyzi[:, :3]
        label_file = path.replace("velodyne", "labels").replace(".bin",
                                                                ".label")
        if os.path.exists(label_file):
            all_labels = np.fromfile(label_file, dtype=np.int32).reshape(-1)
        else:
            all_labels = np.zeros(len(xyzi), np.int32)
        labels = self.label_map[all_labels & 0xFFFF]

        if self.downsample_voxel_size > 0:
            keep, qlabels = sparse_quantize(
                xyzs, self.downsample_voxel_size, labels, self.ignore_label)
            xyzs = xyzs[keep]
            xyzi = xyzi[keep]
            labels = qlabels

        if self.transformations is not None:
            xyzs, xyzi, labels = self.transformations(xyzs, xyzi, labels)
        xyzi = xyzi.copy()
        xyzi[:, :3] = xyzs[:, :3]
        feats = select_features(
            self.features,
            {
                "xyzi": xyzi,
                "xyzs": xyzs,
                "intensities": xyzi[:, 3:4],
                "ones": np.ones_like(xyzi[:, 3:4]),
            },
        )
        seq, _, filename = self.pc_files[i].split("/")
        return {
            "coordinates": (xyzs / self.voxel_size).astype(np.float32),
            "features": feats,
            "labels": labels.astype(np.int32),
            "metadata": {
                "file": self.pc_files[i],
                "sequence": seq,
                "filename": filename,
                "data_index": i,
            },
        }

    def save_prediction(self, prediction, save_path, metadata):
        """Write ``prediction`` (train ids) as raw ids, uint32, to
        ``<save_path>/sequences/<seq>/predictions/<frame>.label``; returns
        the path."""
        pred_file = os.path.join(
            save_path, "sequences", metadata["sequence"], "predictions",
            metadata["filename"].replace("bin", "label"),
        )
        os.makedirs(os.path.dirname(pred_file), exist_ok=True)
        pred = np.asarray(prediction).astype(np.int64)
        self.label_inv_map[pred].astype(np.uint32).tofile(pred_file)
        return pred_file
