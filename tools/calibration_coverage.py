#!/usr/bin/env python3
"""How far knobs calibrated from a few batches cover later batches.

    python3 tools/calibration_coverage.py [--train 2,8] [--seeds 0,1,2]
        [--fresh 24] [--voxels 10000] [--batch 16] [--device cuda]
        [--out cover.json]

Writes the synthetic PeRFception-CO3D tree of ``chip_smoke.py``'s phase
``cli_cls`` (32 train and 8 val shells of ``--voxels`` voxels at 128^3;
``data.synthetic.write_co3d_tree``) and reads it with the README's
classification configs (``co3d_cls.gin`` + ``co3d_aug3.gin``, batches of
``--batch`` scenes, val batches of half that). For each run seed in
``--seeds`` (the host transforms' and the DataModule's seed) it draws
``--fresh`` train batches from an independent stream (seed + 1000), then
calibrates the capacity knobs three ways and reports, for each knob set,
``calibrate.coverage_report`` of every fresh batch (covered?, rows per
level, the stride-1 plan's escaped entries, flagged tiles and far
overflow):

- for each count N in ``--train``: ``calibrate`` on the run's first N
  train batches and its first validation batch (the reference's
  ``maybe_auto_calibrate`` measures two train batches);
- ``"port"``: the port's ``maybe_auto_calibrate``, whose knobs the
  training CLI binds.

Every knob set of a seed faces the same fresh batches. The card's name and
power limit lead the output; one JSON line per seed and knob set follows.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("co3d_cls.gin", "co3d_aug3.gin", "feature_sh.gin",
           "resnet14.gin")
KNOBS = ("level_caps", "window_tile", "window_size", "window_blocks",
         "window_cross_blocks", "window_expand_factor", "window_escape_cap",
         "window_escape_tiles")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--train", default="2,8")
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--fresh", type=int, default=24)
    parser.add_argument("--voxels", type=int, default=10_000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)

    import numpy as np

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.data import transforms
    from nerf_downstream_tpu_torch.data.data_module import DataModule
    from nerf_downstream_tpu_torch.data.synthetic import write_co3d_tree
    from nerf_downstream_tpu_torch.device import resolve_device
    from nerf_downstream_tpu_torch.serve import card_info
    from nerf_downstream_tpu_torch.utils import calibrate as C

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_info(), flush=True)
    tmp = tempfile.mkdtemp(prefix="coverage_")
    lines = []

    def data_module(seed):
        gin.clear_config()  # no knobs bound by an earlier calibration
        gin.parse_config_files_and_bindings(
            [os.path.join(REPO, "co3d_3d", "configs", c) for c in CONFIGS],
            [f'Co3DDatasetBase.data_root = "{root}"'])
        transforms.seed(seed)
        return DataModule(batch_size=args.batch,
                          val_batch_size=args.batch // 2,
                          train_num_workers=1, val_num_workers=1, seed=seed)

    try:
        root, _ = write_co3d_tree(tmp, np.random.default_rng(0), n_train=32,
                                  n_val=8, n_voxels=args.voxels,
                                  reso=(128, 128, 128), num_classes=51)
        for seed in [int(v) for v in args.seeds.split(",")]:
            it = data_module(seed + 1000).train_batches()
            fresh = [{k: b[k] for k in ("coordinates", "mask")}
                     for b in (next(it) for _ in range(args.fresh))]
            for n_train in [int(v) for v in args.train.split(",")] + [
                    "port"]:
                dm = data_module(seed)
                t0 = time.perf_counter()
                if n_train == "port":
                    C.maybe_auto_calibrate(dm, device=dev)
                    knobs = {k: gin.query_parameter(f"CoordinateContext.{k}")
                             for k in KNOBS}
                else:
                    it = dm.train_batches()
                    batches = [next(it) for _ in range(n_train)]
                    batches.append(next(dm.val_batches()))
                    knobs = C.calibrate(batches, device=dev)
                seconds = time.perf_counter() - t0
                report = [C.coverage_report(knobs, b, dev) for b in fresh]
                line = {"seed": seed, "train_batches": n_train,
                        "knobs": knobs, "calibrate_seconds": seconds,
                        "fresh_not_covered": sum(not r["covered"]
                                                 for r in report),
                        "fresh": report}
                lines.append(line)
                print(json.dumps(line), flush=True)
    finally:
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
