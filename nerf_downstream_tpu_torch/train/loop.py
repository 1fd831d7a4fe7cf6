"""Trainer: the step loop, validation cadence, checkpointing, logging
(counterpart of ``nerf_downstream_tpu/train/loop.py``, one device).

The reference's contract: ``max_steps``, ``val_every_n_steps`` and
``log_every_n_steps``; the best-on-monitor and last checkpoints; the
NaN-loss guard (every capacity guard NaN-poisons, so a non-finite train or
validation loss raises); ``resume_from_checkpoint`` (weights, optimizer
state and step); and the final ``test(ckpt_path="best")`` pass. A step's
metrics are read one step late, so logging does not wait for the card
before the next step is queued.

Data parallelism (``devices > 1``, ``parallel_mode``, ``model_parallel``)
is not ported and raises (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from nerf_downstream_tpu_torch.train import checkpoints
from nerf_downstream_tpu_torch.train.loggers import BaseLogger
from nerf_downstream_tpu_torch.train.profilers import SumProfiler


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch as tensors on ``device`` (coordinates,
    features and images f32, mask and sample_mask bool, labels int64,
    dists f32); ``metadata`` rides along, other keys are dropped."""
    kinds = {"coordinates": torch.float32, "features": torch.float32,
             "images": torch.float32,
             "mask": torch.bool, "labels": torch.int64,
             "dists": torch.float32, "sample_mask": torch.bool}
    out = {k: torch.as_tensor(batch[k], dtype=dt, device=device)
           for k, dt in kinds.items() if k in batch}
    if "metadata" in batch:
        out["metadata"] = batch["metadata"]
    return out


class Trainer:
    def __init__(
        self,
        task,
        datamodule,
        max_steps: int = 10000,
        max_epochs: int = -1,
        val_every_n_steps: Optional[int] = None,
        log_every_n_steps: int = 10,
        loggers: Sequence[BaseLogger] = (),
        default_root_dir: str = "./outputs",
        monitor_metric: str = "val/mIoU",
        monitor_mode: str = "max",
        profiler: Optional[SumProfiler] = None,
        resume_from_checkpoint: Optional[str] = None,
        reset_profiler_every_n_steps: int = 1000,
        seed: int = 0,
        devices: int = 1,
        parallel_mode: str = "ddp",
        model_parallel: int = 1,
        device="cuda",
    ):
        if devices > 1 or parallel_mode != "ddp" or model_parallel > 1:
            raise NotImplementedError(
                f"devices={devices}, parallel_mode={parallel_mode!r}, "
                f"model_parallel={model_parallel}: data and model "
                "parallelism are not ported (ROADMAP.md Queue 1 item 4)")
        self.task = task
        self.datamodule = datamodule
        self.max_steps = max_steps
        self.max_epochs = max_epochs
        self.val_every_n_steps = val_every_n_steps
        self.log_every_n_steps = log_every_n_steps
        self.loggers = list(loggers)
        self.default_root_dir = default_root_dir
        self.monitor_metric = monitor_metric
        self.monitor_mode = monitor_mode
        self.profiler = profiler or SumProfiler()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.reset_profiler_every_n_steps = reset_profiler_every_n_steps
        self.seed = seed
        self.devices = devices
        self.device = torch.device(device)
        self.best_score = -np.inf if monitor_mode == "max" else np.inf
        self.best_ckpt_path = os.path.join(default_root_dir, "best.ckpt")
        self.last_ckpt_path = os.path.join(default_root_dir, "last.ckpt")
        os.makedirs(default_root_dir, exist_ok=True)

    # ------------------------------------------------------------------

    def _log(self, metrics: dict, step: int):
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def _is_better(self, score: float) -> bool:
        if self.monitor_mode == "max":
            return score > self.best_score
        return score < self.best_score

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, state=None):
        task = self.task
        dm = self.datamodule

        train_iter = dm.train_batches()
        with self.profiler.profile("get_train_batch"):
            first_batch = next(train_iter)
        if state is None:
            state = task.create_state()
        if self.resume_from_checkpoint:
            raw = checkpoints.load_checkpoint(self.resume_from_checkpoint)
            checkpoints.restore_into(state, raw, weights=True, optimizer=True)
            state.step = int(raw["global_step"])
            logging.info(
                f"Resumed from {self.resume_from_checkpoint} at step "
                f"{raw['global_step']}"
            )

        start_step = int(state.step)
        pending = None  # (step, device metrics) read one step late
        mets = None
        batch = first_batch

        max_steps = self.max_steps
        if self.max_epochs and self.max_epochs > 0:
            spe = getattr(dm, "steps_per_epoch", None)
            if callable(spe):
                max_steps = min(max_steps, spe() * self.max_epochs)

        for step in range(start_step, max_steps):
            with self.profiler.profile("run_training_batch"):
                state, mets = task.train_step(
                    state, to_device(batch, self.device))

            if pending is not None:
                self._emit_train_logs(*pending)
            log_due = step % self.log_every_n_steps == 0 and step > 0
            pending = (step, mets) if log_due else None

            if (
                step % self.reset_profiler_every_n_steps == 0
                and step > 0
            ):
                self.profiler.reset()

            if (
                self.val_every_n_steps
                and step > 0
                and step % self.val_every_n_steps == 0
            ):
                self._sync()
                val_metrics = self.validate(state)
                self._maybe_checkpoint(state, val_metrics)

            if step + 1 < max_steps:
                with self.profiler.profile("get_train_batch"):
                    batch = next(train_iter)

        if pending is not None:
            self._emit_train_logs(*pending)
        self._sync()
        # fail loud even when the run is shorter than the log cadence: a
        # capacity overflow poisons the loss with NaN and must never
        # produce a checkpoint that looks trained
        if mets is not None:
            self._check_finite_loss({k: float(v) for k, v in mets.items()})
        checkpoints.save_training_state(self.last_ckpt_path, state)
        if not os.path.exists(self.best_ckpt_path):
            checkpoints.save_training_state(self.best_ckpt_path, state)
        return state

    @staticmethod
    def _check_finite_loss(mets, phase: str = "train"):
        loss = float(mets.get("loss", 0.0))
        if not np.isfinite(loss):
            hint = ""
            ratio = mets.get("ignore_ratio")  # percentage (0-100)
            if ratio is not None and float(ratio) >= 99.999:
                hint = (
                    " NOTE: ignore_ratio == 100% — every label in the batch "
                    "remapped to ignore, so the CE mean is 0/0; check the "
                    "dataset's label space (ScanNet expects raw nyu40 ids)."
                )
            raise ValueError(
                f"Invalid {phase} loss: {loss}. On the windowed conv path a "
                "non-finite loss usually means a level-cap, window-escape "
                "or escape-list overflow — all guards NaN-poison rather "
                "than silently truncate. Fixes: raise "
                "CoordinateContext.level_caps / level_cap_decay, "
                "window_escape_cap or window_blocks to this dataset's "
                "statistics." + hint
            )

    def _emit_train_logs(self, step: int, mets):
        host = {k: float(v) for k, v in mets.items()}
        self._check_finite_loss(host)
        out = {f"train/{k}": v for k, v in host.items()}
        out["train/lr"] = self.task.current_lr(step)
        out["train/data_time"] = self.profiler.recorded_time("get_train_batch")
        out["train/iter_time"] = self.profiler.recorded_time(
            "run_training_batch"
        )
        self._log(out, step)

    def _maybe_checkpoint(self, state, val_metrics: dict):
        checkpoints.save_training_state(self.last_ckpt_path, state)
        score = val_metrics.get(self.monitor_metric)
        if score is not None and self._is_better(score):
            self.best_score = score
            checkpoints.save_training_state(
                self.best_ckpt_path, state,
                meta={self.monitor_metric: score},
            )
            logging.info(
                f"New best {self.monitor_metric}={score:.4f} -> "
                f"{self.best_ckpt_path}"
            )

    # ------------------------------------------------------------------

    def validate(self, state, phase: str = "val") -> dict:
        task = self.task
        task.on_validation_start()
        results = []
        for batch in self.datamodule.val_batches(phase):
            t0 = time.perf_counter()
            dev_batch = to_device(batch, self.device)
            logits, mets = task.eval_step(state, dev_batch)
            self._sync()
            iter_time = time.perf_counter() - t0
            task.validation_batch_end(logits, dev_batch)
            host = {k: float(v) for k, v in mets.items()}
            self._check_finite_loss(host, phase=phase)
            host["iter_time"] = iter_time
            results.append(host)
        out = task.validation_epoch_end(results, self.default_root_dir)
        step = int(state.step)
        for k in ["OA", "loss", "iter_time"]:
            vals = [r[k] for r in results if k in r]
            if vals and f"val/{k}" not in out:
                out[f"val/{k}"] = float(np.mean(vals))
        self._log(out, step)
        logging.info({k: round(v, 4) for k, v in out.items()})
        return out

    def test(self, state=None, ckpt_path: str = "best", phase: str = "test"):
        if state is None:
            raise ValueError("test() needs a state to bind the checkpoint to")
        if ckpt_path == "best":
            ckpt_path = self.best_ckpt_path
        elif ckpt_path == "last":
            ckpt_path = self.last_ckpt_path
        if ckpt_path and os.path.exists(ckpt_path):
            raw = checkpoints.load_checkpoint(ckpt_path)
            checkpoints.restore_into(state, raw, weights=True)
        return self.validate(state, phase=phase)
