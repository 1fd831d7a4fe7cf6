"""Logger fan-out: csv / jsonl / tensorboard / wandb (counterpart of
``nerf_downstream_tpu/train/loggers.py``).

CSV and JSONL write the reference's files. The tensorboard and wandb
loggers degrade as the reference's do: where
``torch.utils.tensorboard`` cannot be imported (or its writer cannot be
made) TensorBoard logs one warning and logs nothing; where ``wandb`` is
absent the wandb logger warns and logs nothing, and ``wandb.init`` is
tried ``retries`` times (100), ``retry_wait`` seconds (5) apart, before
it gives up the same way. ``active`` says whether a logger writes.
neptune/testtube degrade to a warning, as in the reference.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time

from nerf_downstream_tpu_torch import config as cfg


class BaseLogger:
    active = True

    def log_metrics(self, metrics: dict, step: int):
        raise NotImplementedError

    def log_hyperparams(self, params: dict):
        pass

    def finalize(self):
        pass


class CSVLogger(BaseLogger):
    def __init__(self, save_dir: str, name: str = "default"):
        self.dir = os.path.join(save_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.csv")
        self._fields: list[str] = ["step"]
        self._rows: list[dict] = []

    def log_metrics(self, metrics: dict, step: int):
        row = {"step": step, **{k: _scalar(v) for k, v in metrics.items()}}
        for k in row:
            if k not in self._fields:
                self._fields.append(k)
        self._rows.append(row)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields)
            w.writeheader()
            w.writerows(self._rows)

    def log_hyperparams(self, params: dict):
        with open(os.path.join(self.dir, "hparams.json"), "w") as f:
            json.dump({k: repr(v) for k, v in params.items()}, f, indent=2)


class JSONLLogger(BaseLogger):
    def __init__(self, save_dir: str, name: str = "default"):
        os.makedirs(os.path.join(save_dir, name), exist_ok=True)
        self.path = os.path.join(save_dir, name, "metrics.jsonl")

    def log_metrics(self, metrics: dict, step: int):
        with open(self.path, "a") as f:
            f.write(
                json.dumps(
                    {"step": step, **{k: _scalar(v) for k, v in metrics.items()}}
                )
                + "\n"
            )


class TensorBoardLogger(BaseLogger):
    def __init__(self, save_dir: str, name: str = "default"):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(os.path.join(save_dir, name))
        except Exception as e:
            logging.warning(f"tensorboard unavailable ({e}); logging disabled")

    @property
    def active(self) -> bool:
        return self.writer is not None

    def log_metrics(self, metrics: dict, step: int):
        if self.writer is None:
            return
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(k, _scalar(v), step)
            except Exception:
                pass
        self.writer.flush()  # the trainer never closes its loggers

    def finalize(self):
        if self.writer is not None:
            self.writer.close()


class RetryingWandbLogger(BaseLogger):
    """The reference's retry loop around ``wandb.init``."""

    def __init__(self, project: str, name: str | None = None,
                 save_dir: str = ".", retries: int = 100,
                 retry_wait: float = 5.0):
        self.run = None
        try:
            import wandb
        except ImportError:
            logging.warning("wandb not installed; WandbLogger disabled")
            return
        for attempt in range(retries):
            try:
                self.run = wandb.init(project=project, name=name,
                                      dir=save_dir, reinit=True)
                break
            except Exception as e:
                logging.warning(f"wandb init failed ({e}); retry {attempt}")
                time.sleep(retry_wait)

    @property
    def active(self) -> bool:
        return self.run is not None

    def log_metrics(self, metrics: dict, step: int):
        if self.run is not None:
            self.run.log({k: _scalar(v) for k, v in metrics.items()},
                         step=step)

    def log_hyperparams(self, params: dict):
        if self.run is not None:
            self.run.config.update({k: repr(v) for k, v in params.items()},
                                   allow_val_change=True)

    def finalize(self):
        if self.run is not None:
            self.run.finish()


class NullLogger(BaseLogger):
    active = False

    def __init__(self, kind: str):
        logging.warning(f"logger {kind!r} unavailable in this build; skipped")

    def log_metrics(self, metrics: dict, step: int):
        pass


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


@cfg.configurable("logged")
def logged(hyper_params: list = ()):  # gin hook (reference loggers.py:28-30)
    return {p: cfg.query_parameter(p, default=None) for p in hyper_params}


def get_logger(
    logger_name: str,
    save_dir: str,
    run_name: str = "default",
    project_name: str = "nerf-downstream-tpu",
) -> BaseLogger:
    """reference loggers.py:98-130."""
    if logger_name == "csv":
        return CSVLogger(save_dir, run_name)
    if logger_name == "jsonl":
        return JSONLLogger(save_dir, run_name)
    if logger_name in ("tensorboard", "tb"):
        return TensorBoardLogger(save_dir, run_name)
    if logger_name == "wandb":
        return RetryingWandbLogger(project_name, run_name, save_dir)
    if logger_name in ("neptune", "testtube"):
        return NullLogger(logger_name)
    raise ValueError(f"unknown logger {logger_name!r}")
