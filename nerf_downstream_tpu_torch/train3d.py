"""Training entry point: Res16UNet sparse-voxel segmentation training steps
on the GPU.

Mirrors the reference's ``SegmentationTraining.make_train_step`` and its
training benchmark (``bench.py::bench_3d_train``), as ``serve.py`` mirrors
the eval step: each step runs the device augmentation (feature jitter and
the elastic warp), quantizes with duplicate averaging, runs the windowed
U-Net forward in train mode (BatchNorm batch statistics), the weighted
cross entropy, the backward through the windowed-conv kernels, and an SGD
update.

    python -m nerf_downstream_tpu_torch.train3d --preset train_64k \\
        --steps 5 --seed 0

builds a synthetic batch from the seed, takes the steps on the card and
prints one JSON line per step with its time, loss and whether the loss is
finite, then a summary line with the card's name and power limit.

Preset ``train_64k`` copies the benchmark's 64k ``BLOCK_BINDINGS``
(``bench.py:58-84``: 8 scenes at 65,536 rows, grid extent 160, the window
knobs, duplicate averaging, ElasticDistortion ``[(4, 16)]`` at ratio 0.7)
and its task (``bench.py:109-124``: SGD at lr 0.1 with no schedule,
ignore label -100, device transforms RandomFeatureJitter and
ElasticDistortion), with Res16UNet18A in bf16. ``train_8k`` is the same
step on one scene at 8,192 rows with the window knobs of the serving
preset ``serving_8k``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from nerf_downstream_tpu_torch.convert import (
    init_flax_variables,
    load_flax_variables,
)
from nerf_downstream_tpu_torch.data.synthetic import collate_mink, scene_sample
from nerf_downstream_tpu_torch.device import resolve_device
from nerf_downstream_tpu_torch.models import get_model
from nerf_downstream_tpu_torch.serve import (
    IGNORE_LABEL,
    IN_CHANNELS,
    NUM_CLASSES,
    VOXELS_PER_SCENE,
    card_info,
    to_device,
)
from nerf_downstream_tpu_torch.train.modules import SegmentationTraining

_TASK = dict(
    optimizer_name="SGD", scheduler_name="none", lr=0.1,
    ignore_label=IGNORE_LABEL,
    device_transforms=("RandomFeatureJitter", "ElasticDistortion"),
    transform_params={"ElasticDistortion": dict(
        distortion_params=((4, 16),), application_ratio=0.7)},
)

PRESETS = {
    "train_64k": dict(
        scenes=8, capacity=65536, grid_extent=160, assume_unique=False,
        ctx=dict(
            method="hybrid", level_caps=(65536, 14848, 3584, 1024, 512),
            window_tile=256, window_size=128, window_blocks=4,
            window_expand_factor=3,
            window_escape_cap=(8192, 2048, 512, 512, 0),
            window_escape_tiles=(64, 12, 6, 6, 6),
        ),
        task=_TASK,
    ),
    # one scene at the serving preset's capacity and window knobs
    "train_8k": dict(
        scenes=1, capacity=8192, grid_extent=160, assume_unique=False,
        ctx=dict(
            method="hybrid", level_caps=(8192, 2048, 512, 256, 256),
            window_tile=256, window_size=128, window_blocks=4,
            window_expand_factor=3,
            window_escape_cap=(1024, 256, 64, 0, 0),
            window_escape_tiles=(16, 4, 2, 2, 2),
        ),
        task=_TASK,
    ),
}


def build_training(name: str = "Res16UNet18A", preset: str = "train_64k",
                   device="cuda", *, seed: int = 0,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   **model_kwargs):
    """(task, state) for ``preset``: a Res16UNet on ``device`` with the
    preset's window knobs and random weights from ``seed`` (through the
    flax-tree converter), and its training task with a fresh optimizer.
    ElasticDistortion's noise grid spans the preset's grid extent.
    Raises without a GPU unless ``device="cpu"``."""
    dev = resolve_device(device)
    p = PRESETS[preset]
    model = get_model(
        name, in_channel=IN_CHANNELS, out_channel=NUM_CLASSES,
        compute_dtype=compute_dtype, ctx=p["ctx"],
        assume_unique=p["assume_unique"], **model_kwargs,
    )
    load_flax_variables(model, init_flax_variables(model, seed))
    model.to(dev).train()
    kw = dict(p["task"], num_scenes=p["scenes"])
    kw["transform_params"] = {
        k: dict(v, max_extent=p["grid_extent"]) if k == "ElasticDistortion"
        else dict(v) for k, v in kw["transform_params"].items()}
    task = SegmentationTraining(model, **kw)
    return task, task.create_state()


def make_batch(preset: str, rng) -> dict:
    """One training batch of the preset: its scenes, collated at its
    capacity (numpy)."""
    p = PRESETS[preset]
    samples = [scene_sample(rng, VOXELS_PER_SCENE, NUM_CLASSES)
               for _ in range(p["scenes"])]
    return collate_mink(samples, capacity=p["capacity"],
                        ignore_label=IGNORE_LABEL,
                        grid_extent=p["grid_extent"])


def train_step(task, state, batch: dict):
    """One training step; a numpy batch is moved to the model's device
    first. Returns (state, metrics) as ``SegmentationTraining.train_step``
    does."""
    if not torch.is_tensor(batch["coordinates"]):
        batch = to_device(batch, next(state.model.parameters()).device)
    return task.train_step(state, batch)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="train_64k")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    task, state = build_training("Res16UNet18A", args.preset, seed=args.seed)
    dev = next(state.model.parameters()).device
    batch = to_device(make_batch(args.preset, np.random.default_rng(args.seed)),
                      dev)
    times, losses = [], []
    for i in range(args.steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, mets = train_step(task, state, batch)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        loss = float(mets["loss"])
        losses.append(loss)
        print(json.dumps({"step": i, "ms": times[-1], "loss": loss,
                          "finite": bool(np.isfinite(loss)),
                          "mIoU": float(mets["mIoU"])}), flush=True)
    print(json.dumps({
        "preset": args.preset, "steps": args.steps, "ms_first": times[0],
        "ms_median_after_first": (float(np.median(times[1:]))
                                  if len(times) > 1 else None),
        "all_finite": bool(np.isfinite(losses).all()),
        "distinct_losses": len(set(losses)),
        "device": card_info(),
    }))


if __name__ == "__main__":
    main()
