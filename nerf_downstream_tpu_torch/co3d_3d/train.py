"""3D training CLI (counterpart of ``co3d_3d/train.py``).

    python -m nerf_downstream_tpu_torch.co3d_3d.train \\
        --ginc co3d_3d/configs/scannet_plenoxel.gin \\
        --ginc co3d_3d/configs/scannet_feature_sh.gin \\
        --ginb 'PlenoxelScannetDataset.data_root = "<root>"' \\
        --save_path experiments/run --seed 1

takes the reference's arguments (``--ginc --ginb --save_path --resume
--run_name --run_name_postfix --seed --debug``) and its gin-configurable
``train(...)`` surface, and writes its outputs into ``save_path``:
``<run_name>/metrics.csv`` (and ``metrics.jsonl`` with the ``jsonl``
logger), ``last.ckpt`` and ``best.ckpt`` in the reference's msgpack layout
(weights, optimizer state, step), ``eval_results.json``, the per-class IoU
table and the ``val/mIoU`` log lines. ``--device`` defaults to ``cuda`` and
raises without a GPU; ``--device cpu`` runs the kernels' plain PyTorch
versions on the host.

Every 3D config of the reference runs: ``scannet_plenoxel.gin`` and
``scannet_semseg.gin`` (segmentation, Res16UNet), ``co3d_cls.gin``
(classification, ResNet) and ``modelnet40_cls.gin`` (classification,
MinkowskiFCNN on the row path; ``monitor_metric = "val/acc1"`` picks the
best checkpoint). With a val batch smaller than the train batch (as
``modelnet40_cls.gin`` binds) the classification loss drops the model's
spare scene slots, where the reference's CLI raises at its first
validation. A windowed
config that binds neither ``CoordinateContext.level_caps`` nor
``window_escape_cap`` is calibrated from its own batches first
(``utils/calibrate.py::maybe_auto_calibrate``, on the run's device; off
with ``train.auto_calibrate = False``); ``python -m
nerf_downstream_tpu_torch.co3d_3d.calibrate`` pins the knobs offline.

A fresh model is initialised from ``--seed`` with the reference's
distributions (``train.modules.init_variables``). The parts the port lacks
raise instead of falling back: ``--gpus`` above 1, ``parallel_mode``,
``model_parallel`` and ``--dist_*`` (ROADMAP.md Queue 1 item 4). Every
optimizer of ``train/optim.py`` (``train.optimizer_name``), the csv,
jsonl, tensorboard and wandb loggers (``train.loggers``),
``train.transfer_self_supervised`` and process workers
(``DataModule.worker_mode = "process"``) run through the same bindings
as in the reference.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import time
from typing import Optional

import torch

from nerf_downstream_tpu_torch import config as gin
from nerf_downstream_tpu_torch.data.data_module import DataModule
from nerf_downstream_tpu_torch.device import resolve_device
from nerf_downstream_tpu_torch.models import get_model
from nerf_downstream_tpu_torch.train.loggers import get_logger, logged
from nerf_downstream_tpu_torch.train.loop import Trainer
from nerf_downstream_tpu_torch.train.modules import (
    get_training_module,
    init_variables,
)
from nerf_downstream_tpu_torch.train.profilers import SumProfiler


def setup_logger(run_name: str, debug: bool = False):
    """Console logging with host-tag prefixes (the reference's)."""
    host = socket.gethostname()
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format=f"%(asctime)s [{host}:{run_name}] %(levelname)s %(message)s",
        force=True,
    )


def seed_everything(seed: int):
    import random

    import numpy as np

    from nerf_downstream_tpu_torch.data import transforms as T

    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)
    T.seed(seed)


@gin.configurable
def train(
    save_path: str = "experiments",
    gpus: int = 1,
    parallel_mode: str = "ddp",
    model_parallel: int = 1,
    run_name: Optional[str] = None,
    run_name_postfix: Optional[str] = None,
    project_name: str = "nerf-downstream-tpu",
    max_steps: int = 10000,
    max_epochs: int = -1,
    warmup_steps: int = -1,
    model=None,
    training_module: str = "SegmentationTraining",
    optimizer_name: str = "SGD",
    scheduler_name: str = "PolyLR",
    scheduler_interval: str = "step",
    lr: float = 1e-3,
    weight_decay: float = 1e-4,
    batch_size: int = 8,
    val_batch_size: int = 6,
    prune_batch_size: int = 8,
    train_num_workers: int = 4,
    val_num_workers: int = 2,
    collate_func_name: str = "collate_mink",
    val_every_n_steps: int = 1000,
    log_every_n_steps: int = 10,
    reset_profiler_every_n_steps: int = 1000,
    progressbar_refresh_rate: int = 1,
    loggers: list = ("csv",),
    resume_training: bool = False,
    checkpoint_path: Optional[str] = None,
    load_weights: bool = False,
    load_optimizers: bool = False,
    transfer_self_supervised: bool = False,
    use_sync_batchnorm: bool = False,
    use_sync_grad: bool = False,
    ignore_label: int = -100,
    train_phase: str = "train",
    val_phase: str = "val",
    test_phase: str = "test",
    monitor_metric: str = "val/mIoU",
    evaluate: bool = False,
    void_weight: Optional[float] = None,
    debug: bool = False,
    seed: int = 777,
    capacity: Optional[int] = None,
    device_transforms: tuple = (),
    auto_calibrate: bool = True,
    device: str = "cuda",
):
    os.makedirs(save_path, exist_ok=True)
    if gpus > 1 or parallel_mode != "ddp" or model_parallel > 1:
        raise NotImplementedError(
            f"gpus={gpus}, parallel_mode={parallel_mode!r}, model_parallel="
            f"{model_parallel}: multi-GPU training is not ported (ROADMAP.md "
            "Queue 1 item 4)")
    dev = resolve_device(device)
    if model is None:
        # gin supplies the model's knobs and its CoordinateContext's
        model = get_model(num_batches=batch_size, ctx=None,
                          assume_unique=None)
        init_variables(model, seed)
    model.to(dev)

    if run_name is None or "default" in str(run_name).lower() or run_name == "":
        run_name = f"b{batch_size}x{gpus}-{type(model).__name__}"
    if run_name_postfix:
        run_name += "-" + run_name_postfix
    logging.info(f"== run name: {run_name}")

    data_module = DataModule(
        train_phase=train_phase,
        val_phase=val_phase,
        test_phase=test_phase,
        batch_size=batch_size,
        val_batch_size=val_batch_size,
        train_num_workers=train_num_workers,
        val_num_workers=val_num_workers,
        collate_func_name=collate_func_name,
        ignore_label=ignore_label,
        capacity=capacity,
    )

    if auto_calibrate:
        # measure and bind the windowed convs' capacity knobs when the
        # config carries none; a no-op for a measured config
        from nerf_downstream_tpu_torch.utils.calibrate import (
            maybe_auto_calibrate,
        )

        dist = torch.distributed
        procs = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        if procs > 1:
            # per-process scans would bind different shapes per process
            if maybe_auto_calibrate(data_module, dry_run=True):
                raise ValueError(
                    "multi-process runs need pinned capacity knobs: run "
                    "python -m nerf_downstream_tpu_torch.co3d_3d.calibrate "
                    "offline and compose the generated gin")
        else:
            t0 = time.perf_counter()
            if maybe_auto_calibrate(data_module, device=dev):
                logging.info("auto-calibrated windowed-conv capacity knobs "
                             f"in {time.perf_counter() - t0:.2f} s")

    task = get_training_module(training_module)(
        model,
        optimizer_name=optimizer_name,
        scheduler_name=scheduler_name,
        lr=lr,
        weight_decay=weight_decay,
        warmup_steps=warmup_steps,
        ignore_label=ignore_label,
        void_weight=void_weight,
        log_every_n_steps=log_every_n_steps,
        reset_profiler_every_n_steps=reset_profiler_every_n_steps,
        load_weights=load_weights,
        load_optimizers=load_optimizers,
        transfer_self_supervised=transfer_self_supervised,
        checkpoint_path=checkpoint_path,
        debug=debug,
        use_sync_grad=use_sync_grad,
        datamodule=data_module,
        scheduler_interval=scheduler_interval,
        device_transforms=tuple(device_transforms),
    )

    logger_objs = [
        get_logger(name, save_path, run_name, project_name) for name in loggers
    ]
    hparams = logged()
    for lg in logger_objs:
        lg.log_hyperparams(hparams)

    profiler = SumProfiler()
    warmup = warmup_steps if warmup_steps and warmup_steps > 0 else 0
    trainer = Trainer(
        task,
        data_module,
        max_steps=max_steps + warmup,
        max_epochs=max_epochs,
        val_every_n_steps=val_every_n_steps,
        log_every_n_steps=log_every_n_steps,
        loggers=logger_objs,
        default_root_dir=save_path,
        monitor_metric=monitor_metric,
        profiler=profiler,
        resume_from_checkpoint=(
            os.path.join(save_path, "last.ckpt")
            if resume_training
            and os.path.exists(os.path.join(save_path, "last.ckpt"))
            else None
        ),
        reset_profiler_every_n_steps=reset_profiler_every_n_steps,
        seed=seed,
        devices=max(gpus, 1),
        parallel_mode=parallel_mode,
        model_parallel=model_parallel,
        device=dev,
    )
    state = trainer.fit()
    logging.info("\n" + profiler.summary())

    if evaluate:
        results = trainer.test(state, ckpt_path="best", phase=test_phase)
        with open(os.path.join(save_path, "eval_results.json"), "w") as f:
            json.dump({k: float(v) for k, v in results.items()}, f)
    return state


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ginc", action="append", help="gin config file")
    parser.add_argument("--ginb", action="append", help="gin bindings")
    parser.add_argument("--save_path", type=str, default="experiments")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--run_name_postfix", type=str, default=None)
    parser.add_argument("--gpus", type=int, default=1,
                        help="devices (only 1 is ported)")
    parser.add_argument("--seed", type=int, default=777)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--dist_coordinator", type=str, default=None)
    parser.add_argument("--dist_num_processes", type=int, default=None)
    parser.add_argument("--dist_process_id", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    run_name = args.run_name if args.run_name is not None else "default"
    if args.run_name_postfix is not None:
        run_name = f"{run_name}-{args.run_name_postfix}"
    run_name += f"_{args.seed}"
    setup_logger(run_name, args.debug)

    if (args.dist_coordinator or args.dist_num_processes
            or args.dist_process_id is not None):
        raise NotImplementedError(
            "multi-process training (--dist_*) is not ported (ROADMAP.md "
            "Queue 1 item 4)")
    dev = resolve_device(args.device)
    logging.info(f"Device: {dev} ({torch.cuda.device_count()} CUDA devices "
                 "visible)")
    ginbs = [f"train.gpus={args.gpus}"]
    if args.ginb:
        ginbs.extend(args.ginb)
    logging.info(f"Gin configuration files: {args.ginc}")
    logging.info(f"Gin bindings: {ginbs}")

    seed_everything(args.seed)
    gin.parse_config_files_and_bindings(args.ginc, ginbs)
    return train(
        save_path=args.save_path,
        resume_training=args.resume,
        run_name=args.run_name,
        run_name_postfix=args.run_name_postfix,
        seed=args.seed,
        device=args.device,
    )


if __name__ == "__main__":
    main()
