"""2D datasets and DataModule (counterpart of
``nerf_downstream_tpu/data/loader2d.py``, the port's own copy: the same
seeds give the same frames, augmentations and batch order).

- Co3DTrainDataset: real CO3D frames, one random frame per scene per epoch
  (loader.py:100-107), AugMix over the train transform pipeline.
- Co3DEvalDataset: every frame of every scene.
- PeRFCeptionCo3DTrainDataset: rendered ``fgbg/`` frames (50/scene) with
  background-swap augmentation (prob ``bkgd_aug``, loader.py:172-193).
- PeRFCeptionCo3DEvalDataset.
- DataModule: toggles real-vs-rendered via train_co3d/eval_co3d; the
  train order comes from ``default_rng(seed)``, validation batches are
  padded to ``chunks`` with a ``sample_mask``.

Frame choice and the background swap draw from the process's
``np.random`` (seeded by the CLI), the transforms from
``transforms2d._rng`` and AugMix from ``augmix._rng``. Workers are the
port's thread pool (``data_module._Prefetcher``); with more than one the
draws interleave in completion order, as in the reference.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, List, Optional

import numpy as np
from PIL import Image

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data import transforms2d as T2
from nerf_downstream_tpu_torch.data.augmix import augment_and_mix
from nerf_downstream_tpu_torch.data.co3d import CLASSES_IDX
from nerf_downstream_tpu_torch.data.data_module import _Prefetcher

TRAIN_TRANSFORMS = (
    "RandomResizedCrop", "ColorJitter", "RandomHorizontalFlip", "ToTensor",
    "PCALoss", "Normalize",
)
EVAL_TRANSFORMS = ("CenterCrop", "ToTensor", "Normalize")


def _read_filelist(path: str):
    with open(path) as f:
        return [l.rstrip("/\n").split() for l in f if l.strip()]


class _FrameDatasetBase:
    def __len__(self):
        return len(self.files)


@cfg.configurable("Co3DTrainDataset")
class Co3DTrainDataset(_FrameDatasetBase):
    def __init__(
        self,
        train_transformations: List[str] = list(TRAIN_TRANSFORMS),
        data_root: str = "co3d_2d/data/co3d",
        filelist_dir: str = "filelist",
    ):
        self.transforms = T2.build(train_transformations)
        self.files, self.labels, self.num_frames = [], [], []
        for cls_name, scene_name, frame_num in _read_filelist(
            os.path.join(filelist_dir, "train.txt")
        ):
            self.files.append(
                os.path.join(data_root, cls_name, scene_name, "images")
            )
            self.num_frames.append(int(frame_num))
            self.labels.append(CLASSES_IDX[cls_name])

    def __getitem__(self, idx):
        frames = sorted(os.listdir(self.files[idx]))
        fname = frames[int(np.random.randint(len(frames)))]
        x = Image.open(os.path.join(self.files[idx], fname))
        x = augment_and_mix(x, self.transforms)
        return {"images": x, "labels": self.labels[idx]}


@cfg.configurable("Co3DEvalDataset")
class Co3DEvalDataset(_FrameDatasetBase):
    def __init__(
        self,
        phase: str,
        eval_transformations: List[str] = list(EVAL_TRANSFORMS),
        data_root: str = "co3d_2d/data/co3d",
        filelist_dir: str = "filelist",
    ):
        self.transforms = T2.build(eval_transformations)
        self.files, self.labels = [], []
        for cls_name, scene_name, _ in _read_filelist(
            os.path.join(filelist_dir, f"{phase}.txt")
        ):
            images = os.path.join(data_root, cls_name, scene_name, "images")
            for frame in sorted(os.listdir(images)):
                self.files.append(os.path.join(images, frame))
                self.labels.append(CLASSES_IDX[cls_name])

    def __getitem__(self, idx):
        x = Image.open(self.files[idx])
        return {"images": self.transforms(x), "labels": self.labels[idx]}


@cfg.configurable("PeRFCeptionCo3DTrainDataset")
class PeRFCeptionCo3DTrainDataset(_FrameDatasetBase):
    def __init__(
        self,
        train_transformations: List[str] = list(TRAIN_TRANSFORMS),
        bkgd_aug: float = 0.0,
        data_root: str = "co3d_2d/data/perfception",
        filelist_dir: str = "filelist",
        frames_per_scene: int = 50,
    ):
        self.transforms = T2.build(train_transformations)
        self.bkgd_aug = bkgd_aug
        self.frames_per_scene = frames_per_scene
        self.files, self.labels = [], []
        for cls_name, scene_name, _ in _read_filelist(
            os.path.join(filelist_dir, "train.txt")
        ):
            self.files.append(
                os.path.join(data_root, cls_name, scene_name, "fgbg")
            )
            self.labels.append(CLASSES_IDX[cls_name])
        if bkgd_aug > 0:
            self.bkgd_aug_fun = T2.BackgroundAug()

    def __getitem__(self, idx):
        frames = sorted(os.listdir(self.files[idx]))
        fi = int(np.random.randint(min(self.frames_per_scene, len(frames))))
        fname = frames[fi]
        x = Image.open(os.path.join(self.files[idx], fname))
        if np.random.random() < self.bkgd_aug:
            bkgd_idx = int(np.random.randint(len(self.files)))
            bkgd_fi = int(np.random.randint(self.frames_per_scene))
            bg_dir = self.files[bkgd_idx].replace("fgbg", "bg")
            mask_dir = self.files[idx].replace("fgbg", "mask")
            bg_path = os.path.join(bg_dir, f"image{bkgd_fi:03d}.jpg")
            mask_path = os.path.join(mask_dir, f"mask{fname[5:]}")
            try:
                bg = Image.open(bg_path)
                mask = Image.open(mask_path)
                x = self.bkgd_aug_fun(x, bg, mask)
            except FileNotFoundError:
                logging.debug("bkgd/mask frame missing; skipping composite")
        x = augment_and_mix(x, self.transforms)
        return {"images": x, "labels": self.labels[idx]}


@cfg.configurable("PeRFCeptionCo3DEvalDataset")
class PeRFCeptionCo3DEvalDataset(_FrameDatasetBase):
    def __init__(
        self,
        phase: str,
        eval_transformations: List[str] = list(EVAL_TRANSFORMS),
        data_root: str = "co3d_2d/data/perfception",
        filelist_dir: str = "filelist",
    ):
        self.transforms = T2.build(eval_transformations)
        self.files, self.labels = [], []
        for cls_name, scene_name, _ in _read_filelist(
            os.path.join(filelist_dir, f"{phase}.txt")
        ):
            images = os.path.join(data_root, cls_name, scene_name, "fgbg")
            for frame in sorted(os.listdir(images)):
                self.files.append(os.path.join(images, frame))
                self.labels.append(CLASSES_IDX[cls_name])

    def __getitem__(self, idx):
        x = Image.open(self.files[idx])
        return {"images": self.transforms(x), "labels": self.labels[idx]}


def collate_images(samples: list[dict]) -> dict:
    return {
        "images": np.stack([s["images"] for s in samples]).astype(np.float32),
        "labels": np.asarray([s["labels"] for s in samples], np.int32),
    }


@cfg.configurable("DataModule")
class DataModule2D:
    """2D DataModule. Its gin name is "DataModule", as the co3d_2d configs
    bind it; importing this module registers it under that name in place
    of the 3D one (each CLI imports its own)."""

    def __init__(
        self,
        num_workers: int = 8,
        batch_size: int = 32,
        chunks: int = 32,
        train_co3d: bool = True,
        eval_co3d: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.num_workers = num_workers
        self.batch_size = batch_size
        self.chunks = chunks
        self.train_co3d = train_co3d
        self.eval_co3d = eval_co3d
        self.rng = np.random.default_rng(seed)
        self.process_index = process_index
        self.process_count = process_count
        self._train = None
        self._eval = {}

    def train_dataset(self):
        if self._train is None:
            self._train = (
                Co3DTrainDataset() if self.train_co3d
                else PeRFCeptionCo3DTrainDataset()
            )
        return self._train

    def eval_dataset(self, phase):
        if phase not in self._eval:
            self._eval[phase] = (
                Co3DEvalDataset(phase) if self.eval_co3d
                else PeRFCeptionCo3DEvalDataset(phase)
            )
        return self._eval[phase]

    def steps_per_epoch(self) -> int:
        return max(1, len(self.train_dataset()) // (
            self.batch_size * self.process_count
        ))

    def train_batches(self) -> Iterator[dict]:
        ds = self.train_dataset()
        shard = list(range(self.process_index, len(ds), self.process_count))
        while True:
            order = self.rng.permutation(shard)
            groups = [
                order[i : i + self.batch_size]
                for i in range(
                    0, len(order) - self.batch_size + 1, self.batch_size
                )
            ]

            def load(g):
                return collate_images([ds[int(i)] for i in g])

            yield from _Prefetcher(load, groups, self.num_workers)

    def val_batches(self, phase: str = "val") -> Iterator[dict]:
        ds = self.eval_dataset(phase)
        shard = list(range(self.process_index, len(ds), self.process_count))
        groups = [
            shard[i : i + self.chunks] for i in range(0, len(shard), self.chunks)
        ]

        def load(g):
            batch = collate_images([ds[int(i)] for i in g])
            b = len(batch["labels"])
            if b < self.chunks:  # pad ragged final batch, mask in metrics
                pad = self.chunks - b
                batch["images"] = np.concatenate(
                    [batch["images"],
                     np.zeros((pad, *batch["images"].shape[1:]), np.float32)]
                )
                batch["labels"] = np.concatenate(
                    [batch["labels"], np.zeros(pad, np.int32)]
                )
                batch["sample_mask"] = np.arange(self.chunks) < b
            return batch

        return iter(_Prefetcher(load, groups, self.num_workers))
