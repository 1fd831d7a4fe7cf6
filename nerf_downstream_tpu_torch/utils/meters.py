"""Host-side meters and timers (counterpart of
``nerf_downstream_tpu/utils/meters.py``).

numpy equivalents of AverageMeter/Timer/HistogramAccumulator/IoUAccumulator;
device-side metric math lives in ``train/metrics.py``.
"""

from __future__ import annotations

import time

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Timer:
    """Cumulative wall-clock timer with tic/toc."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    @property
    def avg(self):
        return self.average_time

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff


class HistogramAccumulator:
    """Accumulate confusion-matrix histograms across scenes."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.hist = np.zeros((num_classes, num_classes), np.int64)

    def update(self, hist):
        self.hist += np.asarray(hist, np.int64)

    def per_class_iou(self):
        inter = np.diag(self.hist)
        union = self.hist.sum(1) + self.hist.sum(0) - inter
        return inter / np.maximum(union, 1)


class IoUAccumulator:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.seen = np.zeros(num_classes, np.int64)
        self.correct = np.zeros(num_classes, np.int64)
        self.positive = np.zeros(num_classes, np.int64)

    def update(self, seen, correct, positive):
        self.seen += np.asarray(seen, np.int64)
        self.correct += np.asarray(correct, np.int64)
        self.positive += np.asarray(positive, np.int64)

    def compute(self):
        union = self.seen + self.positive - self.correct
        iou = self.correct / np.maximum(union, 1)
        acc = self.correct / np.maximum(self.seen, 1)
        return iou, acc


def coordinate_hash(coords: np.ndarray) -> np.ndarray:
    """Stable row hash of integer coordinates (reference utils ``_hash``)."""
    coords = np.asarray(coords, np.int64)
    h = np.zeros(len(coords), np.uint64)
    for d in range(coords.shape[1]):
        h = h * np.uint64(1000003) + coords[:, d].astype(np.uint64)
    return h
