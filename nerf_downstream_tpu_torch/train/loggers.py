"""Logger fan-out: csv / jsonl (counterpart of
``nerf_downstream_tpu/train/loggers.py``).

CSV and JSONL write the reference's files. The tensorboard and wandb
loggers are not ported (ROADMAP.md Queue 1 item 1) and raise;
neptune/testtube degrade to a warning, as in the reference.
"""

from __future__ import annotations

import csv
import json
import logging
import os

from nerf_downstream_tpu_torch import config as cfg


class BaseLogger:
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


class NullLogger(BaseLogger):
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
    if logger_name in ("tensorboard", "tb", "wandb"):
        raise NotImplementedError(
            f"logger {logger_name!r} is not ported (ROADMAP.md Queue 1 "
            "item 1); use csv or jsonl")
    if logger_name in ("neptune", "testtube"):
        return NullLogger(logger_name)
    raise ValueError(f"unknown logger {logger_name!r}")
