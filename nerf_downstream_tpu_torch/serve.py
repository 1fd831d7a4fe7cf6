"""Serving entry point: Res16UNet sparse-voxel segmentation on the GPU.

Mirrors the reference's ``SegmentationTraining.make_eval_step`` and its
serving benchmark (``bench.py::bench_serving_latency``): one forward pass
of the windowed-conv U-Net per request, then loss and step metrics.

    python -m nerf_downstream_tpu_torch.serve --preset serving_8k \
        --requests 5 --seed 0

builds synthetic scenes from the seed, answers the requests on the card
and prints one JSON line per request with its latency, then a summary
line with the card's name and power limit.

Presets copy the reference's window knobs:
``serving_8k`` is one ~7.8k-voxel scene at 8k rows (``bench.py:317-328``);
``eval_64k`` is the 8-scene, 64k-row eval batch (``bench.py:58-84`` with
the eval overrides of ``bench.py:256-260``; the train-only device
transforms do not apply).
"""

from __future__ import annotations

import argparse
import json
import subprocess
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
from nerf_downstream_tpu_torch.sparse.types import PointField
from nerf_downstream_tpu_torch.train.loop import to_device
from nerf_downstream_tpu_torch.train.modules import loss_and_metrics

NUM_CLASSES = 20
IN_CHANNELS = 27
IGNORE_LABEL = -100
VOXELS_PER_SCENE = 7_800

PRESETS = {
    "serving_8k": dict(
        scenes=1, capacity=8192, grid_extent=128, assume_unique=True,
        ctx=dict(
            method="hybrid", level_caps=(8192, 2048, 512, 256, 256),
            window_tile=256, window_size=128, window_blocks=4,
            window_expand_factor=3,
            window_escape_cap=(1024, 256, 64, 0, 0),
            window_escape_tiles=(16, 4, 2, 2, 2),
        ),
    ),
    "eval_64k": dict(
        scenes=8, capacity=65536, grid_extent=128, assume_unique=True,
        ctx=dict(
            method="hybrid", level_caps=(65536, 14848, 3584, 1024, 512),
            window_tile=256, window_size=128, window_blocks=4,
            window_expand_factor=3,
            window_escape_cap=(8192, 2048, 512, 512, 0),
            window_escape_tiles=(64, 12, 6, 6, 6),
        ),
    ),
}


def build_segmenter(name: str = "Res16UNet18A",
                    out_channel: int = NUM_CLASSES,
                    ctx_preset: str = "serving_8k", device="cuda", *,
                    seed: int = 0,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    **model_kwargs):
    """A Res16UNet in eval mode on ``device`` with the window knobs of
    ``ctx_preset`` and random weights from ``seed``, carried through the
    flax-tree converter. Raises without a GPU unless ``device="cpu"``."""
    dev = resolve_device(device)
    preset = PRESETS[ctx_preset]
    model = get_model(
        name, in_channel=IN_CHANNELS, out_channel=out_channel,
        compute_dtype=compute_dtype, ctx=preset["ctx"],
        assume_unique=preset["assume_unique"], **model_kwargs,
    )
    load_flax_variables(model, init_flax_variables(model, seed))
    return model.to(dev).eval()


def make_batch(preset_name: str, rng) -> dict:
    """One request of the preset: its scenes, collated at its capacity."""
    preset = PRESETS[preset_name]
    samples = [scene_sample(rng, VOXELS_PER_SCENE, NUM_CLASSES)
               for _ in range(preset["scenes"])]
    return collate_mink(samples, capacity=preset["capacity"],
                        ignore_label=IGNORE_LABEL,
                        grid_extent=preset["grid_extent"])


def eval_step(model, batch: dict):
    """(logits [N, classes] f32, {"loss", "oa", "hist", "mIoU"}) of one
    batch; numpy batches are moved to the model's device. Points labelled
    ``IGNORE_LABEL`` count in neither the loss nor the metrics."""
    device = next(model.parameters()).device
    if not torch.is_tensor(batch["coordinates"]):
        batch = to_device(batch, device)
    with torch.inference_mode():
        field = PointField(coords=batch["coordinates"],
                           feats=batch["features"], mask=batch["mask"])
        logits = model(field)
        loss, mets = loss_and_metrics(
            logits, batch["labels"], batch["mask"], logits.shape[-1],
            ignore_label=IGNORE_LABEL,
        )
    return logits, {"loss": loss, "oa": mets["OA"], "hist": mets["hist"],
                    "mIoU": mets["mIoU"]}


def card_info() -> str:
    """``name, power limit`` of the first GPU as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="serving_8k")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    model = build_segmenter("Res16UNet18A", ctx_preset=args.preset,
                            seed=args.seed)
    dev = next(model.parameters()).device
    rng = np.random.default_rng(args.seed)
    batches = [to_device(make_batch(args.preset, rng), dev)
               for _ in range(args.requests)]
    times = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, mets = eval_step(model, batch)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        times.append(ms)
        valid = batch["mask"]
        print(json.dumps({
            "request": i, "ms": ms,
            "finite": bool(torch.isfinite(logits[valid]).all()),
            "loss": float(mets["loss"]), "mIoU": float(mets["mIoU"]),
        }), flush=True)
    print(json.dumps({
        "preset": args.preset, "requests": args.requests,
        "ms_first": times[0],
        "ms_median_after_first": (float(np.median(times[1:]))
                                  if len(times) > 1 else None),
        "device": card_info(),
    }))


if __name__ == "__main__":
    main()
