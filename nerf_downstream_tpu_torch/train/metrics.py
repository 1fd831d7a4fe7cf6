"""Metrics: confusion histogram, per-class IoU, IoU meter, overall and
top-k accuracy (counterpart of ``nerf_downstream_tpu/train/metrics.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def fast_hist(pred: torch.Tensor, label: torch.Tensor, n: int):
    """Confusion counts [n, n]: rows = label, cols = pred. Rows whose label
    is outside [0, n) are not counted."""
    k = (label >= 0) & (label < n)
    idx = torch.where(k, n * label + pred, n * n).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx <= n * n), idx, n * n)
    # a scatter-add of ones: bincount sizes its output from the data's
    # maximum, which makes the host wait for the card
    counts = torch.zeros(n * n + 1, dtype=torch.int64, device=idx.device)
    return counts.scatter_add_(0, idx, torch.ones_like(idx))[: n * n].reshape(
        n, n)


def per_class_iu(hist: torch.Tensor) -> torch.Tensor:
    """IoU per class from a confusion matrix."""
    inter = torch.diagonal(hist)
    union = hist.sum(1) + hist.sum(0) - inter
    return inter / torch.clamp(union, min=1)


def precision_at_one(pred: torch.Tensor, target: torch.Tensor,
                     ignore_label: int = 255) -> torch.Tensor:
    """Overall accuracy in percent over the targets that are not
    ``ignore_label``."""
    valid = target != ignore_label
    correct = (pred == target) & valid
    return 100.0 * correct.sum() / torch.clamp(valid.sum(), min=1)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks=(1, 5)) -> dict:
    """{"acc<k>": percent of rows whose label is among the k largest
    logits} (a stable descending sort, as the reference's)."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    labels = labels.to(order.dtype)
    return {f"acc{k}": 100.0 * (order[:, :k] == labels[:, None]).any(-1)
            .to(torch.float32).mean() for k in ks}


@dataclasses.dataclass(frozen=True)
class IoUMeterState:
    """Per-class sums over batches: labels seen, correct, predicted."""

    total_seen: torch.Tensor
    total_correct: torch.Tensor
    total_positive: torch.Tensor

    @classmethod
    def create(cls, num_classes: int) -> "IoUMeterState":
        z = torch.zeros(num_classes, dtype=torch.int64)
        return cls(total_seen=z, total_correct=z, total_positive=z)


def iou_update(state: IoUMeterState, pred, label, valid,
               num_classes: int) -> IoUMeterState:
    """Add one batch of flat predictions/labels under a validity mask."""
    c = num_classes

    def count(x):
        return torch.bincount(x.to(torch.int64), minlength=c + 1)[:c]

    lab = torch.where(valid, label, c)
    prd = torch.where(valid, pred, c)
    correct = torch.where(valid & (pred == label), label, c)
    return IoUMeterState(
        total_seen=state.total_seen + count(lab),
        total_correct=state.total_correct + count(correct),
        total_positive=state.total_positive + count(prd),
    )


def iou_compute(state: IoUMeterState, void_label: int | None = None) -> dict:
    """Per-class IoU/accuracy and their means over the classes seen,
    excluding ``void_label``."""
    seen = state.total_seen.cpu().numpy().astype(np.float64)
    correct = state.total_correct.cpu().numpy().astype(np.float64)
    positive = state.total_positive.cpu().numpy().astype(np.float64)
    union = seen + positive - correct
    iou = correct / np.maximum(union, 1)
    acc = correct / np.maximum(seen, 1)
    keep = np.ones(len(seen), bool)
    if void_label is not None and 0 <= void_label < len(seen):
        keep[void_label] = False
    keep &= seen > 0
    return {
        "iou_per_class": iou,
        "acc_per_class": acc,
        "mIoU": float(iou[keep].mean()) if keep.any() else 0.0,
        "mAcc": float(acc[keep].mean()) if keep.any() else 0.0,
    }
