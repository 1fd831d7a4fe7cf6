"""3D evaluation CLI (counterpart of ``co3d_3d/eval.py``).

    python -m nerf_downstream_tpu_torch.co3d_3d.eval \\
        --ginc co3d_3d/configs/scannet_plenoxel.gin \\
        --ginc co3d_3d/configs/scannet_feature_sh.gin \\
        --ginb 'PlenoxelScannetDataset.data_root = "<root>"' \\
        --load_path experiments/run/best.ckpt --tag best

takes the reference's arguments (``--ginc --ginb --training_module
--save_path --load_path --seed --convert_powernorm --sparsify
--sparse_mode --debug --visualize --replace --profile --layout --tag``)
and the same gin files, builds the configured model for
``evaluate.val_batch_size`` scenes, loads the checkpoint (the reference's
msgpack layout; pruning masks folded into the weights), prints
``num_params, total=..., net=..., ratio=...``, runs
``Trainer.validate`` on the ``val_phase`` of the configured dataset and
writes ``[val_results]`` to ``<save_path>/<tag>.json`` (``save_path``
defaults to the checkpoint's directory, ``tag`` to
``<run dir>-<device>-<sparsify>``); an existing tag is skipped unless
``--replace`` is given.

- ``--sparsify --sparse_mode a,...`` (nine positive slots): mode-1 convs
  run over the live offsets of the pruned weights
  (``CoordinateContext.valid_offsets_map``), and with ``--layout csr`` or
  ``coo`` over their live weight blocks at
  ``CoordinateContext.block_live_granularity`` (``block_live_map``).
- ``--convert_powernorm``: a model built with ``Res16UNet.NORM_TYPE =
  "PN"`` loads a BatchNorm checkpoint, each BatchNorm's state turned into
  a PowerNorm's (``models/mink/powernorm.py::convert_powernorm_tree``).
- ``--visualize``: the segmentation task writes every second validation
  batch's predictions to ``<save_path>/figure/<tag>/<scene>.npz``.
- ``--profile``: the validation runs under ``train.profilers.
  device_trace``, which writes ``<save_path>/trace/trace.json``.
- ``--device`` defaults to ``cuda`` and raises without a GPU; ``--device
  cpu`` runs the kernels' plain PyTorch versions on the host.
- ``--seed`` seeds the host RNGs (the reference parses it and seeds
  nothing); ``--debug`` is parsed and ignored, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

from nerf_downstream_tpu_torch import config as gin
from nerf_downstream_tpu_torch import convert
from nerf_downstream_tpu_torch.co3d_3d.train import seed_everything
from nerf_downstream_tpu_torch.data.data_module import DataModule
from nerf_downstream_tpu_torch.device import resolve_device
from nerf_downstream_tpu_torch.models import get_model
from nerf_downstream_tpu_torch.train.loop import Trainer
from nerf_downstream_tpu_torch.train.modules import get_training_module
from nerf_downstream_tpu_torch.utils.prune import (
    count_parameters_tree,
    derive_maps,
    parse_sparse_mode,
)


def convert_powernorm_checkpoint(raw: dict) -> dict:
    """A loaded checkpoint (``checkpoints.load_checkpoint``) with every
    BatchNorm that carries ``mean``/``var`` turned into a PowerNorm."""
    from nerf_downstream_tpu_torch.models.mink.powernorm import (
        convert_powernorm_tree,
    )

    params, stats = convert_powernorm_tree(raw["params"], raw["batch_stats"])
    return dict(raw, params=params, batch_stats=stats)


@gin.configurable
def evaluate(
    save_path: Optional[str] = None,
    load_path: Optional[str] = None,
    ignore_label: int = -100,
    training_module: str = "SegmentationTraining",
    log_every_n_steps: int = 5,
    device: str = "cuda",
    convert_powernorm: bool = False,
    layout: str = "csr",
    tag: str = "default",
    visualize: bool = False,
    replace: bool = False,
    profile: bool = False,
    val_phase: str = "val",
    val_batch_size: int = 1,
):
    """Validate the checkpoint ``load_path``; returns the results dict
    (also written to ``<save_path>/<tag>.json``), or None when that file
    exists and ``replace`` is False."""
    os.makedirs(save_path, exist_ok=True)
    json_path = os.path.join(save_path, f"{tag}.json")
    if not replace and os.path.isfile(json_path):
        print("====== skip existing experiment =====")
        return None
    dev = resolve_device(device)

    model = get_model(num_batches=val_batch_size, ctx=None,
                      assume_unique=None).to(dev)
    data_module = DataModule(
        val_batch_size=val_batch_size, val_phase=val_phase,
        ignore_label=ignore_label,
    )
    task = get_training_module(training_module)(
        model,
        export_path=save_path,
        datamodule=data_module,
        save_pred=visualize,
        save_pred_path=os.path.join(save_path, "figure", tag),
        ignore_label=ignore_label,
        checkpoint_path=load_path,
        load_weights=True,
        scheduler_name="none",
        checkpoint_transform=(convert_powernorm_checkpoint
                              if convert_powernorm else None),
    )
    state = task.create_state()
    params = convert.state_dict_to_flax(
        model.state_dict(), convert.flax_layout(model)).get("params", {})
    sparse_mode = gin.query_parameter("get_model.sparse", default=None)
    vmap, bmap = derive_maps(
        params, sparse_mode or [0] * 9, layout,
        gin.query_parameter("CoordinateContext.block_live_granularity",
                            default=128))
    if vmap:
        gin.bind("CoordinateContext", "valid_offsets_map", vmap)
    if bmap:
        gin.bind("CoordinateContext", "block_live_map", bmap)
    num_params = count_parameters_tree(params)
    nz = num_params["total"] - num_params["pruned"]
    print(
        f"num_params, total={num_params['total']}, net={nz}, "
        f"ratio={nz / max(num_params['total'], 1) * 100:.2f}"
    )

    trainer = Trainer(
        task,
        data_module,
        default_root_dir=save_path,
        log_every_n_steps=log_every_n_steps,
        device=dev,
    )
    ts = time.time()
    if profile:
        from nerf_downstream_tpu_torch.train.profilers import device_trace

        with device_trace(os.path.join(save_path, "trace")):
            val_results = trainer.validate(state, phase=val_phase)
    else:
        val_results = trainer.validate(state, phase=val_phase)
    logging.info(f"elapsed time: {time.time() - ts} s")
    val_results = {k: float(v) for k, v in val_results.items()}
    with open(json_path, "w") as f:
        f.write(json.dumps([val_results], indent=4))
    return val_results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ginc", action="append", help="gin config file")
    parser.add_argument("--ginb", action="append", help="gin bindings")
    parser.add_argument(
        "--training_module", type=str, default="SegmentationTraining"
    )
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--load_path", type=str, default=None)
    parser.add_argument("--device", type=str, choices=["cuda", "cpu"],
                        default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--seed", type=int, default=777)
    parser.add_argument("--convert_powernorm", action="store_true")
    parser.add_argument("--sparsify", action="store_true")
    parser.add_argument("--sparse_mode", type=str, default="0,0,0,0,0,0,0,0,0")
    parser.add_argument("--debug", action="store_true",
                        help="parsed and ignored, as in the reference")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--replace", action="store_true")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument(
        "--layout", type=str, choices=["csr", "coo", "strided"], default="csr"
    )
    parser.add_argument("--tag", type=str)
    args = parser.parse_args(argv)
    ginbs = list(args.ginb or [])
    sparse_mode = parse_sparse_mode(args.sparsify, args.sparse_mode)
    ginbs.append(f"get_model.sparse={sparse_mode}")

    resolve_device(args.device)
    logging.info(f"Gin configuration files: {args.ginc}")
    logging.info(f"Gin bindings: {ginbs}")
    seed_everything(args.seed)
    gin.parse_config_files_and_bindings(args.ginc, ginbs)

    dataset_name = gin.query_parameter("get_dataset.dataset_name")
    ignore_label = gin.query_parameter(
        f"{dataset_name}.ignore_label", default=-100
    )
    if args.tag is None:
        run = os.path.basename(os.path.dirname(os.path.abspath(
            args.load_path)))
        tag = f"{run}-{args.device}-{args.sparsify}"
    else:
        tag = args.tag
    logging.info(tag)

    save_path = args.save_path or os.path.dirname(args.load_path)
    return evaluate(
        save_path=save_path,
        load_path=args.load_path,
        ignore_label=ignore_label,
        training_module=args.training_module,
        device=args.device,
        convert_powernorm=args.convert_powernorm,
        layout=args.layout,
        tag=tag,
        visualize=args.visualize,
        replace=args.replace,
        profile=args.profile,
    )


if __name__ == "__main__":
    main()
