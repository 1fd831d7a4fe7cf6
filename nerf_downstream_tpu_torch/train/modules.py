"""Task losses, step metrics, the training and eval steps and the
validation hooks (counterpart of ``nerf_downstream_tpu/train/modules.py``:
``BaseTask``, ``SegmentationTraining``, ``ClassificationTraining`` and
``EnsembleClassificationTraining``).

A training step is reproducible on the card and on the CPU: every
accumulating scatter of the step adds in a fixed order (the escape path,
the row path and the gathers' backward go through ``ops/scatter.py``;
the kernels add their f32 partial sums in a fixed order), so two steps
from the same state are bit-identical.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os

import numpy as np
import torch
from torch.nn import functional as F

from nerf_downstream_tpu_torch import config as cfg
from nerf_downstream_tpu_torch.data import device_transforms as DT
from nerf_downstream_tpu_torch.models.interface import process_input
from nerf_downstream_tpu_torch.train import metrics as M
from nerf_downstream_tpu_torch.train.optim import get_optimizer, get_scheduler
from nerf_downstream_tpu_torch.train.state import TrainState

# the dropout generator of step s is seeded with DROPOUT_SEED + s, apart
# from the device augmentation's (seeded with s)
DROPOUT_SEED = 1 << 40


def init_variables(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """A fresh model's weights, in place, with the reference's
    distributions drawn from a ``torch.Generator`` seeded by ``seed``:
    conv kernels He-normal over fan-in K * Cin, PAConv's weight banks
    ``matrice<i>`` normal of variance 2 / Cin, a dense kernel
    LeCun-normal (flax's default: a normal truncated at two standard
    deviations, of variance 1 / fan-in), biases 0, norm scale 1, bias 0,
    running mean 0 and variance 1 (flax's BatchNorm names them scale,
    mean and var), PowerNorm's running_phi 1, iters 0 and ema_gz 0. The
    2D layers of ``models/image`` (the ensemble's image branch) draw
    flax's own distributions through their ``reset_parameters``
    (lecun-normal kernels, a residual branch's last BatchNorm scale at
    0)."""
    from nerf_downstream_tpu_torch.models.image import layers as L2

    gen = torch.Generator().manual_seed(int(seed))
    drawn = set()
    for mname, m in model.named_modules():
        if isinstance(m, (L2.Conv2d, L2.Dense, L2.BatchNorm, L2.LayerNorm)):
            m.reset_parameters(gen)
            drawn.update(f"{mname}.{k}" for k in m.state_dict())
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            if name in drawn:
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel" and t.dim() == 2:
                # flax's truncated normal, rescaled to variance 1 / fan-in
                std = (1.0 / t.shape[0]) ** 0.5 / 0.87962566103423978
                w = torch.empty(t.shape)
                torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                            generator=gen)
                t.copy_(w.to(t.dtype))
            elif leaf.startswith("matrice"):
                # PAConv's bank [Cin, m * Cout]: the reference draws
                # [m, Cin, Cout] of variance 2 / Cin and transposes it;
                # its entries are independent, so one draw in place is
                # the same distribution
                w = torch.randn(t.shape, generator=gen) * (2.0 / t.shape[0]) ** 0.5
                t.copy_(w.to(t.dtype))
            elif leaf == "kernel":
                k, cin, _ = t.shape
                w = torch.randn(t.shape, generator=gen) * (2.0 / (k * cin)) ** 0.5
                t.copy_(w.to(t.dtype))
            elif leaf in ("weight", "scale", "running_var", "var",
                          "running_phi"):
                t.fill_(1.0)
            elif leaf in ("bias", "running_mean", "mean", "iters", "ema_gz"):
                t.zero_()
    return model


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


class BaseTask:
    """What the tasks share: the reference task's constructor arguments,
    the optimizer and schedule, checkpoint loading, and the steps.

    ``train_step`` runs the device augmentation (``device_transforms``,
    drawn from a generator seeded from the step count), the forward in
    train mode (a model with ``uses_dropout`` draws its dropout from a
    generator seeded from the step count plus ``DROPOUT_SEED``), the
    loss, the backward and the optimizer step with the lr of the schedule
    at the step count before the update.
    ``transform_params`` overrides the
    transforms' defaults by name (None: the gin bindings of their host
    twins); ``num_scenes`` is the batch's scene count (ElasticDistortion
    needs it; default the model's ``num_batches``); ``scheduler_kwargs``
    carries what the reference reads from its configuration (for example
    ``max_steps``; filled from the configuration when left out).

    ``checkpoint_path`` with ``load_weights`` / ``load_optimizers`` loads a
    checkpoint into the state ``create_state`` makes (the reference's
    three load modes: with ``transfer_self_supervised`` the weights go
    through ``checkpoints.convert_self_supervised``, which keeps the
    model's own ``final``/``predictor`` leaves and those whose shape
    differs), its pruning masks folded into the weights, after
    ``checkpoint_transform`` (a function of the loaded dict, such as the
    BN -> PN conversion of ``co3d_3d/eval.py``) where one is given. ``axis_name`` (data parallelism) is not ported and raises
    (ROADMAP.md Queue 1 item 4); ``use_sync_grad`` is moot on one device.
    """

    def __init__(self, model, optimizer_name: str = "SGD",
                 scheduler_name: str = "PolyLR", lr: float = 1e-3,
                 weight_decay: float = 1e-5, warmup_steps: int = -1,
                 ignore_label: int = -100, void_weight: float | None = None,
                 device_transforms=(), transform_params: dict | None = None,
                 num_scenes: int | None = None,
                 scheduler_kwargs: dict | None = None,
                 log_every_n_steps: int = 10,
                 reset_profiler_every_n_steps: int = 1000,
                 load_weights: bool = False, load_optimizers: bool = False,
                 transfer_self_supervised: bool = False,
                 checkpoint_path: str | None = None,
                 export_path: str | None = None, debug: bool = False,
                 use_sync_grad: bool = False, datamodule=None,
                 scheduler_interval: str = "step", save_pred: bool = False,
                 save_pred_path: str | None = None, axis_name=None,
                 checkpoint_transform=None):
        if axis_name is not None:
            raise NotImplementedError(
                "data-parallel training (axis_name) is not ported "
                "(ROADMAP.md Queue 1 item 4)")
        if load_weights or load_optimizers:
            assert checkpoint_path is not None
        self.model = model
        self.optimizer_name = optimizer_name
        self.scheduler_name = scheduler_name
        self.lr = lr
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.ignore_label = ignore_label
        self.void_weight = void_weight
        self.scheduler_kwargs = dict(scheduler_kwargs or {})
        self.log_every_n_steps = log_every_n_steps
        self.reset_profiler_every_n_steps = reset_profiler_every_n_steps
        self.load_weights = load_weights
        self.load_optimizers = load_optimizers
        self.transfer_self_supervised = transfer_self_supervised
        self.checkpoint_path = checkpoint_path
        self.checkpoint_transform = checkpoint_transform
        self.export_path = export_path
        self.debug = debug
        self.use_sync_grad = use_sync_grad
        self.datamodule = datamodule
        self.scheduler_interval = scheduler_interval
        self.save_pred = save_pred
        self.save_pred_path = save_pred_path
        self.num_labels = cfg.query_parameter("get_model.out_channel",
                                              default=model.out_channel)
        if transform_params is None:
            transform_params = DT.configured_params(tuple(device_transforms))
        if num_scenes is None:
            num_scenes = getattr(model, "num_batches", None)
        self.device_aug = DT.build(device_transforms, num_scenes,
                                   transform_params)
        self.schedule = get_scheduler(
            scheduler_name, lr, warmup_steps if warmup_steps > 0 else None,
            **self.scheduler_kwargs)

    # -- optimizer / state ---------------------------------------------------

    def create_state(self) -> TrainState:
        """A fresh optimizer and schedule over the model, and the
        configured checkpoint loaded into them. Rprop with a schedule
        raises, as the reference's does (optax's Rprop takes a constant
        initial step size)."""
        if self.optimizer_name == "Rprop" and self.schedule is not None:
            raise TypeError("Rprop takes a constant lr (its initial step "
                            "size); bind scheduler_name = \"none\"")
        opt = get_optimizer(self.optimizer_name, self.model.parameters(),
                            self.lr, self.weight_decay)
        state = TrainState(step=0, model=self.model, optimizer=opt,
                           schedule=self.schedule)
        return self._maybe_load_checkpoint(state)

    def _maybe_load_checkpoint(self, state: TrainState) -> TrainState:
        if self.checkpoint_path is None:
            return state
        from nerf_downstream_tpu_torch.train import checkpoints
        from nerf_downstream_tpu_torch.utils.prune import fold_pruning_masks

        ckpt = checkpoints.load_checkpoint(self.checkpoint_path)
        if self.checkpoint_transform is not None:
            ckpt = self.checkpoint_transform(ckpt)
        ckpt["params"], folded = fold_pruning_masks(ckpt["params"],
                                                    ckpt["pruning_masks"])
        if folded:
            logging.info(f"folded pruning masks: {folded['folded']}")
        if self.load_weights:
            if self.transfer_self_supervised:
                ckpt = self._self_supervised(state, ckpt)
            checkpoints.restore_into(state, ckpt, weights=True)
            logging.info(f"Loaded model weights from {self.checkpoint_path}")
        if self.load_optimizers:
            # the schedule restarts from the new run's lr, as the
            # reference's does
            checkpoints.restore_into(state, ckpt, weights=False,
                                     optimizer=True)
            logging.info(
                f"Loaded optimizer parameters from {self.checkpoint_path}")
        return state

    @staticmethod
    def _self_supervised(state: TrainState, ckpt: dict) -> dict:
        """``ckpt`` with its weights transferred onto the model's own
        (``checkpoints.convert_self_supervised``)."""
        from nerf_downstream_tpu_torch import convert
        from nerf_downstream_tpu_torch.train import checkpoints

        own = convert.state_dict_to_flax(state.model.state_dict(),
                                         convert.flax_layout(state.model))
        params, stats = checkpoints.convert_self_supervised(
            ckpt["params"], ckpt["batch_stats"], own.get("params", {}),
            own.get("batch_stats", {}))
        return dict(ckpt, params=params, batch_stats=stats)

    def current_lr(self, step: int) -> float:
        if self.schedule is None:
            return float(self.lr)
        return float(self.schedule(step))

    # -- steps ---------------------------------------------------------------

    def loss_and_metrics(self, logits, batch):
        """(loss, step metrics) of a batch; the task's own."""
        raise NotImplementedError

    @staticmethod
    def _step_metrics(loss, mets) -> dict:
        return {"loss": loss.detach(),
                **{k: v for k, v in mets.items() if k != "hist"}}

    def augment(self, batch: dict, step: int) -> dict:
        """The batch after the device augmentation of step ``step``."""
        if self.device_aug is None:
            return batch
        dev = batch["coordinates"].device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(step))
        return self.device_aug(batch, gen)

    def model_input(self, batch: dict):
        """What the model takes from a batch: a ``PointField`` of the
        batch's rows (``models/interface.py::process_input``), or a tuple
        of its positional inputs (a dense or joint task overrides it)."""
        return process_input(batch)

    def apply_model(self, model, batch: dict, **kw):
        """The model's output on ``batch`` (its ``model_input``)."""
        inputs = self.model_input(batch)
        if isinstance(inputs, tuple):
            return model(*inputs, **kw)
        return model(inputs, **kw)

    def train_step(self, state: TrainState, batch: dict):
        """One update of ``state`` (in place, and returned) on a batch of
        tensors on the model's device: (state, {"loss", and the task's
        step metrics})."""
        model = state.model.train()
        batch = self.augment(batch, state.step)
        kw = {}
        if getattr(model, "uses_dropout", False):
            gen = torch.Generator(device=batch["coordinates"].device)
            gen.manual_seed(DROPOUT_SEED + int(state.step))
            kw["generator"] = gen
        logits = self.apply_model(model, batch, **kw)
        loss, mets = self.loss_and_metrics(logits, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.lr(self.lr)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, self._step_metrics(loss, mets)

    def eval_step(self, state: TrainState, batch: dict):
        """(logits, {"loss", and the task's step metrics}) of the model in
        eval mode on a batch of tensors on its device."""
        model = state.model.eval()
        with torch.no_grad():
            logits = self.apply_model(model, batch)
            loss, mets = self.loss_and_metrics(logits, batch)
        return logits, self._step_metrics(loss, mets)


@cfg.configurable("SegmentationTraining")
class SegmentationTraining(BaseTask):
    """Per-point segmentation training: the reference's weighted CE with
    ``class_weight`` and ``void_weight`` (the void class is the last one),
    overall accuracy, mIoU and the ignored share per step, and the IoU
    meter, the per-class tables and ``eval_results.json`` at validation.
    """

    def __init__(self, model, **kwargs):
        super().__init__(model, **kwargs)
        self.void_label = cfg.query_parameter(
            "PlenoxelScannetDataset.void_label", default=None)
        w = torch.ones(self.num_labels)
        if self.void_weight is not None and self.void_weight > 0:
            w[-1] = self.void_weight
        self.class_weight = w
        self.iou_state = M.IoUMeterState.create(self.num_labels)
        self.best_miou = -1.0
        self._val_batch_idx = 0

    def loss_and_metrics(self, logits, batch):
        return loss_and_metrics(
            logits, batch["labels"], batch["mask"], self.num_labels,
            self.ignore_label, self.class_weight.to(logits.device))

    # -- validation hooks (the Trainer calls these) --------------------------

    def on_validation_start(self):
        self.iou_state = M.IoUMeterState.create(self.num_labels)
        self._val_batch_idx = 0

    def validation_batch_end(self, logits, batch):
        labels = batch["labels"].to(torch.int64)
        valid = batch["mask"] & (labels != self.ignore_label)
        pred = logits.argmax(-1)
        self.iou_state = M.iou_update(
            self.iou_state, pred.cpu(), labels.cpu(), valid.cpu(),
            self.num_labels)
        # prediction dumping every 2nd batch (the reference's)
        if self.save_pred and self._val_batch_idx % 2 == 0:
            assert self.save_pred_path is not None
            os.makedirs(self.save_pred_path, exist_ok=True)
            meta = batch.get("metadata", [{}])
            inst = meta[0].get("file", f"batch{self._val_batch_idx}")
            dists = batch.get("dists")
            np.savez(
                os.path.join(self.save_pred_path, f"{inst}.npz"),
                coordinates=batch["coordinates"].cpu().numpy(),
                logits=logits.float().cpu().numpy(),
                dists=(np.zeros(0) if dists is None
                       else np.asarray(dists.cpu() if torch.is_tensor(dists)
                                       else dists)),
                labels=labels.cpu().numpy(),
            )
            logging.info(f"saved prediction for {inst}")
        self._val_batch_idx += 1

    def validation_epoch_end(self, step_results, root_dir):
        """val/{OA, loss, mIoU, mAcc, best_mIoU}, the per-class IoU and
        accuracy tables printed, and ``eval_results.json`` in
        ``root_dir``."""
        from nerf_downstream_tpu_torch.data.scannet import CLASS_LABELS

        assert len(step_results) > 0
        out = {}
        for k in ["OA", "loss", "iter_time", "flops"]:
            vals = [r[k] for r in step_results if k in r]
            if vals:
                out[f"val/{k}"] = float(np.mean(vals))
        res = M.iou_compute(self.iou_state, void_label=self.void_label)
        labels = list(CLASS_LABELS[: self.num_labels])
        while len(labels) < self.num_labels:
            labels.append(f"class{len(labels)}")
        argsort = np.argsort(labels)
        class_labels = np.array(labels)[argsort]
        ious = res["iou_per_class"][argsort] * 100
        accs = res["acc_per_class"][argsort] * 100
        print(" & ".join(class_labels))
        print(" & ".join(f"{i:.1f}" for i in ious))
        print(" & ".join(class_labels))
        print(" & ".join(f"{a:.1f}" for a in accs))
        print(f"miou: {res['mIoU']}")
        print(f"macc: {res['mAcc']}")
        result_dict = dict(
            labels=class_labels.tolist(),
            iou=[*ious.tolist(), res["mIoU"]],
            acc=[*accs.tolist(), res["mAcc"]],
        )
        if root_dir:
            with open(os.path.join(root_dir, "eval_results.json"), "w") as f:
                json.dump(result_dict, f)
        out["val/mIoU"] = res["mIoU"] * 100
        out["val/mAcc"] = res["mAcc"] * 100
        if out["val/mIoU"] > self.best_miou:
            self.best_miou = out["val/mIoU"]
        out["val/best_mIoU"] = self.best_miou
        return out


def classification_loss(logits, labels, sample_mask=None):
    """(loss, {"acc1", "acc5"}) of whole-sample classification: the mean
    cross entropy over the samples ``sample_mask`` keeps (all when None;
    the padding of a ragged last val batch is dropped), and the top-1 and
    top-5 accuracy over every row, padding included, as the reference
    counts them. ``logits`` [num_batches, C] may have more rows than
    ``labels`` (a model sized for the train batch on a smaller val
    batch): the rows past the labels are scene slots no sample fills, and
    are left out."""
    b = labels.shape[0]
    if b > logits.shape[0]:
        raise ValueError(f"{b} labels for {logits.shape[0]} scene slots: "
                         "the model's num_batches is below the batch size")
    logits = logits[:b]
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 1, labels.to(torch.int64)[:, None])[:, 0]
    w = (torch.ones_like(nll) if sample_mask is None
         else sample_mask.to(torch.float32))
    loss = (nll * w).sum() / torch.clamp(w.sum(), min=1)
    return loss, M.topk_accuracy(logits, labels, ks=(1, 5))


@cfg.configurable("ClassificationTraining")
class ClassificationTraining(BaseTask):
    """Whole-sample classification (the reference's
    ``ClassificationTraining``): ``classification_loss`` per step, and at
    validation the top-1 and top-5 hits over the samples ``sample_mask``
    keeps: ``val/acc1``, ``val/acc5`` (percent) and ``val/loss``. Both
    tasks are gin-configurable under the reference's names (a binding
    fills a constructor argument no caller passes, such as
    ``ClassificationTraining.checkpoint_path`` for the PAConv CLI)."""

    def __init__(self, model, **kwargs):
        super().__init__(model, **kwargs)
        self._val_correct1 = 0
        self._val_correct5 = 0
        self._val_count = 0

    def loss_and_metrics(self, logits, batch):
        return classification_loss(logits, batch["labels"],
                                   batch.get("sample_mask"))

    def on_validation_start(self):
        self._val_correct1 = 0
        self._val_correct5 = 0
        self._val_count = 0

    def validation_batch_end(self, logits, batch):
        labels = batch["labels"].cpu().numpy()
        lg = logits[: len(labels)].float().cpu().numpy()
        sm = batch.get("sample_mask")
        valid = (np.ones(len(labels), bool) if sm is None
                 else sm.cpu().numpy().astype(bool))
        order = np.argsort(-lg, axis=-1)
        self._val_correct1 += int(((order[:, 0] == labels) & valid).sum())
        self._val_correct5 += int(
            ((order[:, :5] == labels[:, None]).any(-1) & valid).sum())
        self._val_count += int(valid.sum())

    def validation_sums(self):
        return np.array(
            [self._val_correct1, self._val_correct5, self._val_count],
            np.int64)

    def set_validation_sums(self, sums):
        self._val_correct1, self._val_correct5, self._val_count = (
            int(x) for x in np.asarray(sums))

    def validation_epoch_end(self, step_results, root_dir):
        assert len(step_results) > 0
        n = max(self._val_count, 1)
        return {
            "val/acc1": 100.0 * self._val_correct1 / n,
            "val/acc5": 100.0 * self._val_correct5 / n,
            "val/loss": float(
                np.mean([r["loss"] for r in step_results if "loss" in r])),
        }


@cfg.configurable("EnsembleClassificationTraining")
class EnsembleClassificationTraining(ClassificationTraining):
    """Joint 2D+3D classification over ``models/ensemble.py::
    Ensemble2D3D``: batches carry both ``images`` [B, H, W, 3] and the
    rows of the scenes' voxels (``data/joint.py::collate_joint``); the
    model takes ``(images, field)``. As in the reference, the step runs
    no device augmentation. An f32 model's steps and evaluations run its
    cuDNN convolutions and matrix products in real f32 (no TF32) with
    deterministic algorithms, so that two steps from one state are
    bit-identical."""

    def model_input(self, batch: dict):
        return batch["images"], process_input(batch)

    def augment(self, batch: dict, step: int) -> dict:
        return batch

    def _exact(self):
        if getattr(self.model, "compute_dtype", torch.float32) \
                != torch.float32:
            return contextlib.nullcontext()
        return f32_deterministic()

    def train_step(self, state: TrainState, batch: dict):
        with self._exact():
            return super().train_step(state, batch)

    def eval_step(self, state: TrainState, batch: dict):
        with self._exact():
            return super().eval_step(state, batch)


@contextlib.contextmanager
def f32_deterministic():
    """cuDNN convolutions with deterministic algorithms, and CUDA
    convolutions and matrix products in real f32 (no TF32), inside the
    block; the previous settings come back after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


MODULES = {
    "SegmentationTraining": SegmentationTraining,
    "ClassificationTraining": ClassificationTraining,
    "EnsembleClassificationTraining": EnsembleClassificationTraining,
}


def get_training_module(name: str):
    """The task class of ``name`` (the reference's table; the
    ExceptionSafe variant is the standard one, as there)."""
    if name == "ExceptionSafeSegmentationTraining":
        name = "SegmentationTraining"
    if name not in MODULES:
        raise ValueError(f"unknown training module {name!r}")
    return MODULES[name]
