"""2D classification task (counterpart of
``nerf_downstream_tpu/train/modules2d.py``: ``LitModel`` and
``warmup_quarter_cosine``), driven by the port's ``train/loop.py::
Trainer``.

- Cross entropy with label smoothing 0.005, in f32 over the logits.
- Weight decay as the reference's L2-*norm* (not squared) penalty added
  to the loss: ``weight_decay x sum of ||kernel||`` over the kernels whose
  flax path names a conv, ``fc``, a downsample or a dense layer
  (``decayed_kernels``): in a ResNet every conv, ``downsample_conv`` and
  ``fc`` kernel, in a ViT only the two ``MlpBlock`` dense kernels of each
  block (not q/k/v/out, ``patch_embed`` or ``head``).
- ``warmup_quarter_cosine``: linear warmup over the first 10 % of the
  steps, then a quarter cosine, read at the optimizer's step count before
  the update, as optax reads it (the first update has lr 0).
- SGD with momentum 0.9 (``train/optim.py::sgd``, optax's update).
- Validation accuracy over every frame ``sample_mask`` keeps, and
  ``val/loss`` the mean of the per-batch means.

Images arrive NHWC (as the loader writes them) and enter the models as
an NCHW view of the same memory (channels-last strides). Dropout draws
from a ``torch.Generator`` seeded by the step count, so it matches the
reference in distribution, not draw for draw.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch import convert
from nerf_downstream_tpu_torch.train.optim import sgd
from nerf_downstream_tpu_torch.train.state import TrainState


def warmup_quarter_cosine(base_lr: float, total_steps: int):
    """``step -> lr``: linear up to ``base_lr`` at 10 % of the steps, then
    a quarter cosine down to 0 at ``total_steps``."""
    peak = max(int(total_steps * 0.1), 1)

    def schedule(step):
        if step <= peak:
            return base_lr * step / peak
        phase = (step - peak) / max(total_steps - peak, 1)
        return max(base_lr * math.cos(phase * math.pi / 2), 0.0)

    return schedule


def decayed_kernels(model: torch.nn.Module) -> list[str]:
    """Names of the parameters the reference's ``_wdloss`` selects: by its
    rule on the lower-cased flax path of each leaf."""
    names = [n for n, _ in model.named_parameters()]
    path_of = convert.image_flax_path
    out = []
    for n in names:
        path = [p.lower() for p in path_of(n)[1:]]
        if path[-1] == "kernel" and any(
                "conv" in p or p == "fc" or "downsample" in p or "dense" in p
                for p in path):
            out.append(n)
    return out


@cfg.configurable("LitModel")
class LitModel:
    def __init__(
        self,
        model_name: Optional[str] = None,
        lr: float = 0.1,
        weight_decay: float = 1e-4,
        label_smoothing: float = 0.005,
        num_training_steps: int = 10000,
        axis_name: Optional[str] = None,
        use_sync_batchnorm: bool = False,
    ):
        from nerf_downstream_tpu_torch.models.image import select_model

        if axis_name is not None or use_sync_batchnorm:
            raise NotImplementedError(
                "data-parallel 2D training (axis_name, use_sync_batchnorm) "
                "is not ported (ROADMAP.md Queue 1 item 4)")
        self.model_name = model_name
        self.lr = lr
        self.weight_decay = weight_decay
        self.label_smoothing = label_smoothing
        self.model = select_model(model_name)
        self._decayed = set(decayed_kernels(self.model))
        self.set_num_training_steps(num_training_steps)
        self._val_correct = 0
        self._val_count = 0

    def set_num_training_steps(self, n: int):
        self.num_training_steps = n
        self.schedule = warmup_quarter_cosine(self.lr, n)

    def current_lr(self, step) -> float:
        return float(self.schedule(step))

    def create_state(self) -> TrainState:
        """A fresh SGD (momentum 0.9) over the model's parameters, after
        loading the stored pretrained backbone when the model asks for
        one."""
        if getattr(self.model, "pretrained", False):
            from nerf_downstream_tpu_torch.models.image.torch_weights import (
                apply_pretrained,
            )

            apply_pretrained(self.model, self.model.pretrained_arch,
                             self.model.pretrained_submodule)
        opt = sgd(self.model.parameters(), lr=self.lr, momentum=0.9)
        return TrainState(step=0, model=self.model, optimizer=opt,
                          schedule=self.schedule)

    def _celoss(self, logits, labels, sample_mask=None):
        c = logits.shape[-1]
        eps = self.label_smoothing
        onehot = F.one_hot(labels.to(torch.int64), c) * (1 - eps) + eps / c
        logp = F.log_softmax(logits.float(), -1)
        nll = -(onehot * logp).sum(-1)
        if sample_mask is not None:
            w = sample_mask.float()
            return (nll * w).sum() / torch.clamp(w.sum(), min=1)
        return nll.mean()

    def _wdloss(self, model):
        norms = [torch.linalg.vector_norm(p.float())
                 for n, p in model.named_parameters() if n in self._decayed]
        return self.weight_decay * torch.stack(norms).sum()

    def train_step(self, state: TrainState, batch: dict):
        """One update of ``state`` (in place, and returned) on a batch of
        tensors on the model's device: (state, {"loss", "celoss",
        "wdloss", "acc"})."""
        model = state.model.train()
        images = batch["images"].permute(0, 3, 1, 2)
        labels = batch["labels"]
        gen = torch.Generator(device=images.device)
        gen.manual_seed(int(state.step))
        logits = model(images, generator=gen)
        celoss = self._celoss(logits, labels)
        wdloss = self._wdloss(model)
        loss = celoss + wdloss
        acc = 100.0 * (logits.argmax(-1) == labels).float().mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.lr(self.lr)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "celoss": celoss.detach(),
                       "wdloss": wdloss.detach(), "acc": acc}

    def eval_step(self, state: TrainState, batch: dict):
        """(logits, {"loss"}) of the model in eval mode; the loss over the
        frames ``sample_mask`` keeps."""
        model = state.model.eval()
        with torch.no_grad():
            logits = model(batch["images"].permute(0, 3, 1, 2))
            loss = self._celoss(logits, batch["labels"],
                                batch.get("sample_mask"))
        return logits, {"loss": loss}

    # trainer hooks ---------------------------------------------------------
    def on_validation_start(self):
        self._val_correct = 0
        self._val_count = 0

    def validation_batch_end(self, logits, batch):
        labels = batch["labels"].cpu().numpy()
        mask = batch.get("sample_mask")
        valid = (np.ones(len(labels), bool) if mask is None
                 else mask.cpu().numpy().astype(bool))
        pred = logits.argmax(-1).cpu().numpy()
        self._val_correct += int(((pred == labels) & valid).sum())
        self._val_count += int(valid.sum())

    def validation_epoch_end(self, step_results, root_dir) -> dict:
        acc = 100.0 * self._val_correct / max(self._val_count, 1)
        loss = float(np.mean([r["loss"] for r in step_results]))
        return {"val/acc": acc, "val/loss": loss}
