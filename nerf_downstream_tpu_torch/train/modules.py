"""Segmentation loss, step metrics and the training step (counterpart of
``nerf_downstream_tpu/train/modules.py::SegmentationTraining``)."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from nerf_downstream_tpu_torch.data import device_transforms as DT
from nerf_downstream_tpu_torch.sparse.types import PointField
from nerf_downstream_tpu_torch.train import metrics as M
from nerf_downstream_tpu_torch.train.optim import get_optimizer, get_scheduler
from nerf_downstream_tpu_torch.train.state import TrainState


def weighted_ce(logits, labels, valid, class_weight):
    """torch-style weighted cross entropy: sum(w_y * nll) / sum(w_y) over
    the valid rows, in f32."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    lab = labels.clamp(0, logits.shape[-1] - 1).to(torch.int64)
    nll = -torch.gather(logp, 1, lab[:, None])[:, 0]
    w = class_weight[lab] * valid.to(torch.float32)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)


def loss_and_metrics(logits, labels, mask, num_labels: int,
                     ignore_label: int = -100, class_weight=None):
    """(loss, {"OA", "mIoU", "ignore_ratio", "hist"}) of one batch; rows
    with ``ignore_label`` or outside ``mask`` count nowhere.
    ``class_weight`` [num_labels] weighs the cross entropy (ones when
    None)."""
    labels = labels.to(torch.int64)
    valid = mask & (labels != ignore_label)
    if class_weight is None:
        class_weight = torch.ones(num_labels, device=logits.device)
    loss = weighted_ce(logits, labels, valid, class_weight)
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


class SegmentationTraining:
    """Per-point segmentation training: the reference task's constructor
    arguments, its weighted CE with ``class_weight`` and ``void_weight``
    (the void class is the last one), and its step.

    ``train_step`` runs the device augmentation (``device_transforms``,
    drawn from a generator seeded from the step count), the forward in
    train mode, the loss, the backward and the optimizer step with the lr
    of the schedule at the step count before the update. ``transform_params``
    overrides the transforms' defaults by name; ``num_scenes`` is the
    batch's scene count (ElasticDistortion needs it); ``scheduler_kwargs``
    carries what the reference reads from its configuration (for example
    ``max_steps``).
    """

    def __init__(self, model, optimizer_name: str = "SGD",
                 scheduler_name: str = "PolyLR", lr: float = 1e-3,
                 weight_decay: float = 1e-5, warmup_steps: int = -1,
                 ignore_label: int = -100, void_weight: float | None = None,
                 device_transforms=(), transform_params: dict | None = None,
                 num_scenes: int | None = None,
                 scheduler_kwargs: dict | None = None):
        self.model = model
        self.optimizer_name = optimizer_name
        self.scheduler_name = scheduler_name
        self.lr = lr
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.ignore_label = ignore_label
        self.void_weight = void_weight
        self.scheduler_kwargs = dict(scheduler_kwargs or {})
        self.num_labels = model.out_channel
        w = torch.ones(self.num_labels)
        if void_weight is not None and void_weight > 0:
            w[-1] = void_weight
        self.class_weight = w
        self.device_aug = DT.build(device_transforms, num_scenes,
                                   transform_params)

    def create_state(self) -> TrainState:
        opt = get_optimizer(self.optimizer_name, self.model.parameters(),
                            self.lr, self.weight_decay)
        schedule = get_scheduler(
            self.scheduler_name, self.lr,
            self.warmup_steps if self.warmup_steps > 0 else None,
            **self.scheduler_kwargs)
        return TrainState(step=0, model=self.model, optimizer=opt,
                          schedule=schedule)

    def loss_and_metrics(self, logits, batch):
        return loss_and_metrics(
            logits, batch["labels"], batch["mask"], self.num_labels,
            self.ignore_label, self.class_weight.to(logits.device))

    def augment(self, batch: dict, step: int) -> dict:
        """The batch after the device augmentation of step ``step``."""
        if self.device_aug is None:
            return batch
        dev = batch["coordinates"].device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(step))
        return self.device_aug(batch, gen)

    def train_step(self, state: TrainState, batch: dict):
        """One update of ``state`` (in place, and returned) on a batch of
        tensors on the model's device: (state, {"loss", "OA", "mIoU",
        "ignore_ratio"})."""
        model = state.model.train()
        batch = self.augment(batch, state.step)
        field = PointField(coords=batch["coordinates"],
                           feats=batch["features"], mask=batch["mask"])
        logits = model(field)
        loss, mets = self.loss_and_metrics(logits, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.lr(self.lr)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "OA": mets["OA"],
                       "mIoU": mets["mIoU"],
                       "ignore_ratio": mets["ignore_ratio"]}
