"""2D training CLI (counterpart of ``co3d_2d/train.py``).

    python -m nerf_downstream_tpu_torch.co3d_2d.train \\
        --ginc co3d_2d/configs/<family>/<model>.gin [--ginb ...] \\
        [--seed N] [--ckpt_path ...] [--resume_training ...] \\
        [--device cuda|cpu]

reads the same gin files as the reference's CLI and has its
gin-configurable ``run()``: best-on-``val/acc`` and ``last.ckpt`` in
``<log_dir>/<run_name>_<seed>`` (the reference's msgpack layout, which
resumes in either package), epochs turned into steps
(``steps_per_epoch x max_epochs``), and the test phase on ``"best"`` (or
on ``--ckpt_path`` when one is given, as the reference does).

- ``run.precision = 16`` computes in bf16 (``ResNetBased.dtype`` and
  ``ViTBased.dtype``, as the reference binds them); ``32`` in real f32:
  TF32 is switched off for cuDNN and for matrix products for the run
  (cuDNN runs f32 convolutions in TF32 by default). Other values raise.
- ``--seed`` seeds ``random``, ``np.random``, torch, and the 2D
  augmentation streams (``transforms2d._rng``, ``augmix._rng``), which
  the reference leaves unseeded, so two runs with one seed draw the same
  augmentations (ROADMAP.md Queue 3).
- A ViT's position embedding is sized for the train crops
  (``RandomResizedCrop.image_size``) unless ``ViTBased.image_size`` is
  bound.
- ``--device`` defaults to ``cuda`` and raises without a GPU;
  ``--num_gpus`` above 1 raises (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
from typing import Optional

import torch

from nerf_downstream_tpu_torch import config as gin
from nerf_downstream_tpu_torch.data.loader2d import DataModule2D
from nerf_downstream_tpu_torch.device import resolve_device
from nerf_downstream_tpu_torch.models.image import VIT_LIST, init_weights
from nerf_downstream_tpu_torch.train.loggers import get_logger
from nerf_downstream_tpu_torch.train.loop import Trainer
from nerf_downstream_tpu_torch.train.modules2d import LitModel


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError("Boolean value expected.")


def seed_everything(seed: int):
    """The 3D CLI's seeds, and the two 2D augmentation streams."""
    from nerf_downstream_tpu_torch.co3d_3d.train import seed_everything as s3
    from nerf_downstream_tpu_torch.data import augmix
    from nerf_downstream_tpu_torch.data import transforms2d as T2

    s3(seed)
    T2.seed(seed)
    augmix.seed(seed)


@contextlib.contextmanager
def f32_without_tf32():
    """cuDNN convolutions and CUDA matrix products in real f32 (not TF32)
    inside the block; the previous settings are restored after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _bind_vit_image_size():
    if gin.query_parameter("ViTBased.image_size", default=None) is not None:
        return
    size = gin.query_parameter("RandomResizedCrop.image_size", default=224)
    if isinstance(size, (tuple, list)):
        if size[0] != size[1]:
            raise ValueError(f"ViT on non-square crops {size}")
        size = size[0]
    gin.bind("ViTBased", "image_size", int(size))


@gin.configurable
def run(
    ckpt_path: Optional[str] = None,
    resume_training: bool = False,
    seed: int = 0,
    run_name: Optional[str] = None,
    num_gpus: int = 1,
    log_every_n_steps: int = 100,
    max_epochs: int = 1000,
    check_val_every_n_epoch: int = 10,
    precision: int = 16,
    progressbar_refresh_rate: int = 20,
    run_train: bool = True,
    run_eval: bool = True,
    loggers: tuple = ("csv",),
    log_dir: str = "co3d_2d/logs",
    device: str = "cuda",
):
    if num_gpus > 1:
        raise NotImplementedError(
            f"num_gpus={num_gpus}: data-parallel 2D training (DDP, SyncBN) "
            "is not ported (ROADMAP.md Queue 1 item 4)")
    if precision not in (16, 32):
        raise ValueError(f"precision={precision}: 16 (bf16) or 32 (f32)")
    dev = resolve_device(device)
    run_name = (run_name or "default") + f"_{seed}"
    save_dir = os.path.join(log_dir, run_name)
    os.makedirs(save_dir, exist_ok=True)

    if precision == 16:
        gin.bind("ResNetBased", "dtype", torch.bfloat16)
        gin.bind("ViTBased", "dtype", torch.bfloat16)
    if gin.query_parameter("LitModel.model_name", default=None) in VIT_LIST:
        _bind_vit_image_size()

    data_module = DataModule2D()
    task = LitModel()
    init_weights(task.model, seed)
    task.model.to(dev)
    steps_per_epoch = data_module.steps_per_epoch()
    max_steps = steps_per_epoch * max_epochs
    task.set_num_training_steps(max_steps)

    project = "co3d-downstream-2d" if run_train else "co3d-downstream-2d-test"
    logger_objs = [
        get_logger(name, log_dir, run_name, project) for name in loggers
    ]
    trainer = Trainer(
        task,
        data_module,
        max_steps=max_steps,
        val_every_n_steps=steps_per_epoch * check_val_every_n_epoch,
        log_every_n_steps=log_every_n_steps,
        loggers=logger_objs,
        default_root_dir=save_dir,
        monitor_metric="val/acc",
        seed=seed,
        resume_from_checkpoint=ckpt_path if resume_training else None,
        devices=num_gpus,
        device=dev,
    )
    with f32_without_tf32() if precision == 32 else contextlib.nullcontext():
        state = None
        if run_train:
            state = trainer.fit()
        if not run_eval:
            return state
        if state is None:
            state = task.create_state()
        results = trainer.test(
            state,
            ckpt_path="best" if ckpt_path is None else ckpt_path,
            phase="test",
        )
    logging.info(f"test results: {results}")
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ginc", action="append", help="gin config file")
    parser.add_argument("--ginb", action="append", help="gin bindings")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt_path", type=str, default=None)
    parser.add_argument("--resume_training", type=str2bool, default=False)
    parser.add_argument("--num_gpus", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, force=True)
    dev = resolve_device(args.device)
    logging.info(f"Device: {dev} ({torch.cuda.device_count()} CUDA devices "
                 "visible)")
    gin.parse_config_files_and_bindings(args.ginc, args.ginb)
    gin.check_bindings()
    seed_everything(args.seed)
    return run(
        ckpt_path=args.ckpt_path,
        resume_training=args.resume_training,
        seed=args.seed,
        num_gpus=args.num_gpus,
        device=args.device,
    )


if __name__ == "__main__":
    main()
