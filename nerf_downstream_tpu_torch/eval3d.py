"""Preset-driven evaluation of pruned checkpoints on synthetic batches
(the pruned-eval half of ``co3d_3d/eval.py`` without gin and without a
dataset; ``nerf_downstream_tpu_torch.co3d_3d.eval`` is the reference's
command itself).

    python -m nerf_downstream_tpu_torch.eval3d --preset eval_64k \
        --load_path ckpt/last.ckpt --sparsify --sparse_mode 1,1,1,1,1,1,1,1,1 \
        --layout csr --tag pruned

loads the checkpoint (the reference's msgpack format) and folds any
pruning masks into its weights. With ``--sparsify`` and a mode-1 slot it
derives each conv's live offsets from the pruned weights, and with layout
csr or coo each conv's live weight blocks at ``--block_live_granularity``.
It prints ``num_params, total=..., net=..., ratio=...``, evaluates the
preset's synthetic batches (made from ``--seed``) with
``serve.eval_step`` on the card, and writes ``{tag}.json`` to
``--save_path``; an existing tag is skipped unless ``--replace`` is
given. ``--device cpu`` runs the plain PyTorch versions of the kernels.
``--model`` (default ``Res16UNet18A``) takes the place of the reference's
gin binding of the model class, as the keyword arguments of ``main`` take
the place of its bindings of the model's arguments.

Sparse modes (nine slots: slot 0 for ``conv0a``-``conv4``, slots 1-8 for
``block1``-``block8``): 1 runs a conv over the live offsets of its pruned
kernel, 2 over its z-column (ZAXIS), 3 and 4 are dense.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch

from nerf_downstream_tpu_torch import serve
from nerf_downstream_tpu_torch.convert import (
    init_flax_variables,
    load_flax_variables,
)
from nerf_downstream_tpu_torch.device import resolve_device
from nerf_downstream_tpu_torch.models import get_model
from nerf_downstream_tpu_torch.models.mink.layers import (
    SparseConv,
    SparseConvTranspose,
)
from nerf_downstream_tpu_torch.train import metrics as M
from nerf_downstream_tpu_torch.train.checkpoints import load_checkpoint
from nerf_downstream_tpu_torch.utils.prune import (
    count_parameters_tree,
    derive_maps,
    fold_pruning_masks,
    parse_sparse_mode,
)

LAYOUTS = ("csr", "coo", "strided")


def build_evaluator(preset: str, variables: dict, *, sparse_mode=None,
                    valid_offsets_map=None, block_live_map=None,
                    block_live_granularity: int = 128, device="cuda",
                    compute_dtype: torch.dtype = torch.bfloat16,
                    model: str = "Res16UNet18A", **model_kwargs):
    """The model of ``preset``'s window knobs in eval mode on ``device``,
    with ``variables`` (the reference's {"params", "batch_stats"} trees)
    loaded and the pruned-eval maps in its coordinate context. Raises
    without a GPU unless ``device="cpu"``."""
    dev = resolve_device(device)
    p = serve.PRESETS[preset]
    ctx = dict(p["ctx"], grid_extent=p["grid_extent"],
               num_batches=p["scenes"], valid_offsets_map=valid_offsets_map,
               block_live_map=block_live_map,
               block_live_granularity=block_live_granularity)
    net = get_model(model, in_channel=serve.IN_CHANNELS,
                    out_channel=serve.NUM_CLASSES, sparse=sparse_mode,
                    compute_dtype=compute_dtype, ctx=ctx,
                    assume_unique=p["assume_unique"], **model_kwargs)
    load_flax_variables(net, variables)
    return net.to(dev).eval()


def route_counts(model) -> dict[str, int]:
    """How many convs took each route in the model's last forward
    (windowed, blocksparse, row; 1x1 products are not counted)."""
    routes = collections.Counter(
        m.route for m in model.modules()
        if isinstance(m, (SparseConv, SparseConvTranspose))
        and m.route is not None)
    return dict(sorted(routes.items()))


def evaluate(*, preset: str = "eval_64k", load_path: str | None = None,
             save_path: str | None = None, sparse_mode=None,
             layout: str = "csr", block_live_granularity: int = 128,
             tag: str = "default", replace: bool = False, batches: int = 3,
             seed: int = 777, device="cuda", model: str = "Res16UNet18A",
             **model_kwargs) -> dict | None:
    """Evaluate a checkpoint (or seeded random weights without
    ``load_path``) on ``batches`` synthetic batches of ``preset``. Returns
    {"results", "ms", "routes", "num_params"} and writes
    ``[results]`` to ``{save_path}/{tag}.json``; None when that file
    exists and ``replace`` is False."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    if save_path is None:
        if load_path is None:
            raise ValueError("give --save_path (or --load_path)")
        save_path = os.path.dirname(os.path.abspath(load_path))
    os.makedirs(save_path, exist_ok=True)
    json_path = os.path.join(save_path, f"{tag}.json")
    if not replace and os.path.isfile(json_path):
        print("====== skip existing experiment =====")
        return None
    sparse_mode = list(sparse_mode or [0] * 9)
    dev = resolve_device(device)

    if load_path is not None:
        raw = load_checkpoint(load_path)
        params, folded = fold_pruning_masks(raw["params"],
                                            raw["pruning_masks"])
        if folded:
            print(f"folded pruning masks: {folded['folded']}")
        variables = {"params": params, "batch_stats": raw["batch_stats"]}
    else:
        dense = get_model(model, in_channel=serve.IN_CHANNELS,
                          out_channel=serve.NUM_CLASSES, **model_kwargs)
        variables = init_flax_variables(dense, seed)
    vmap, bmap = derive_maps(variables["params"], sparse_mode, layout,
                             block_live_granularity)
    num_params = count_parameters_tree(variables["params"])
    nz = num_params["total"] - num_params["pruned"]
    print(f"num_params, total={num_params['total']}, net={nz}, "
          f"ratio={nz / max(num_params['total'], 1) * 100:.2f}")

    net = build_evaluator(
        preset, variables, sparse_mode=sparse_mode, valid_offsets_map=vmap,
        block_live_map=bmap, block_live_granularity=block_live_granularity,
        device=dev, model=model, **model_kwargs)
    rng = np.random.default_rng(seed)
    data = [serve.to_device(serve.make_batch(preset, rng), dev)
            for _ in range(batches)]
    meter = M.IoUMeterState.create(serve.NUM_CLASSES)
    times, losses, oas = [], [], []
    for batch in data:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, mets = serve.eval_step(net, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        loss = float(mets["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite eval loss {loss} (a capacity "
                               "guard poisoned the batch)")
        losses.append(loss)
        oas.append(float(mets["oa"]))
        labels = batch["labels"].to(torch.int64)
        valid = batch["mask"] & (labels != serve.IGNORE_LABEL)
        meter = M.iou_update(meter, logits.argmax(-1).cpu(), labels.cpu(),
                             valid.cpu(), serve.NUM_CLASSES)
    iou = M.iou_compute(meter)
    results = {"val/mIoU": iou["mIoU"] * 100, "val/mAcc": iou["mAcc"] * 100,
               "val/OA": float(np.mean(oas)),
               "val/loss": float(np.mean(losses)),
               "val/iter_time": float(np.mean(times)) / 1e3}
    with open(json_path, "w") as f:
        f.write(json.dumps([results], indent=4))
    return {"results": results, "ms": times, "routes": route_counts(net),
            "num_params": num_params}


def main(argv=None, **model_kwargs):
    """The CLI; ``model_kwargs`` go to ``get_model`` (the reference binds
    them through gin)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(serve.PRESETS),
                    default="eval_64k")
    ap.add_argument("--model", default="Res16UNet18A",
                    help="model class (the reference binds it through gin)")
    ap.add_argument("--load_path", default=None)
    ap.add_argument("--save_path", default=None)
    ap.add_argument("--sparsify", action="store_true")
    ap.add_argument("--sparse_mode", default="0,0,0,0,0,0,0,0,0")
    ap.add_argument("--layout", choices=LAYOUTS, default="csr")
    ap.add_argument("--block_live_granularity", type=int, default=128)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--replace", action="store_true")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    sparse_mode = parse_sparse_mode(args.sparsify, args.sparse_mode)
    if args.tag is not None:
        tag = args.tag
    elif args.load_path is not None:
        run = os.path.basename(os.path.dirname(os.path.abspath(
            args.load_path)))
        tag = f"{run}-{args.device}-{args.sparsify}"
    else:
        tag = f"{args.preset}-{args.device}-{args.sparsify}"
    out = evaluate(
        preset=args.preset, load_path=args.load_path,
        save_path=args.save_path, sparse_mode=sparse_mode,
        layout=args.layout,
        block_live_granularity=args.block_live_granularity, tag=tag,
        replace=args.replace, batches=args.batches, seed=args.seed,
        device=args.device, model=args.model, **model_kwargs)
    if out is not None:
        summary = dict(out["results"], tag=tag, preset=args.preset,
                       ms=out["ms"], routes=out["routes"])
        if args.device == "cuda":
            summary["device"] = serve.card_info()
        print(json.dumps(summary))
    return out


if __name__ == "__main__":
    main()
