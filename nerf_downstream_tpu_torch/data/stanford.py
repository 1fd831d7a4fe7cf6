"""Stanford S3DIS indoor segmentation (counterpart of
``nerf_downstream_tpu/data/stanford.py``): ``ScannetDataset`` with the
13-class tables and its own split files."""

from __future__ import annotations

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data.scannet import ScannetDataset

CLASS_LABELS = (
    "clutter", "beam", "board", "bookcase", "ceiling", "chair", "column",
    "door", "floor", "sofa", "table", "wall", "window",
)
VALID_CLASS_IDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13)


@cfg.configurable
class StanfordDataset(ScannetDataset):
    NUM_LABELS = 14
    DATA_PATH_FILE = {
        "train": "stanford_train.txt",
        "val": "stanford_val.txt",
        "test": "stanford_test.txt",
    }
    CLASS_LABELS = CLASS_LABELS
    VALID_CLASS_IDS = VALID_CLASS_IDS
