"""Segmentation loss and step metrics (counterpart of the evaluation half
of ``nerf_downstream_tpu/train/modules.py::SegmentationTraining``)."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from nerf_downstream_tpu_torch.train import metrics as M


def weighted_ce(logits, labels, valid, class_weight):
    """torch-style weighted cross entropy: sum(w_y * nll) / sum(w_y) over
    the valid rows, in f32."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    lab = labels.clamp(0, logits.shape[-1] - 1).to(torch.int64)
    nll = -torch.gather(logp, 1, lab[:, None])[:, 0]
    w = class_weight[lab] * valid.to(torch.float32)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)


def loss_and_metrics(logits, labels, mask, num_labels: int,
                     ignore_label: int = -100):
    """(loss, {"OA", "mIoU", "ignore_ratio", "hist"}) of one batch; rows
    with ``ignore_label`` or outside ``mask`` count nowhere."""
    labels = labels.to(torch.int64)
    valid = mask & (labels != ignore_label)
    loss = weighted_ce(logits, labels, valid,
                       torch.ones(num_labels, device=logits.device))
    pred = logits.argmax(-1)
    correct = ((pred == labels) & valid).sum()
    total = valid.sum()
    oa = 100.0 * correct / torch.clamp(total, min=1)
    hist = M.fast_hist(
        torch.where(valid, pred, num_labels + 1),
        torch.where(valid, labels, num_labels + 1),
        num_labels,
    )
    n_ignored = (mask & (labels == ignore_label)).sum()
    ious = M.per_class_iu(hist) * 100
    return loss, {
        "OA": oa,
        "mIoU": ious.to(torch.float32).mean(),
        "ignore_ratio": 100.0 * n_ignored / torch.clamp(mask.sum(), min=1),
        "hist": hist,
    }
