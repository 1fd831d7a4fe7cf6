"""Calibration CLI (counterpart of ``co3d_3d/calibrate.py``): derive the
windowed convs' capacity knobs from a scan of the configured data and
write them as a gin file to compose into later runs:

    python -m nerf_downstream_tpu_torch.co3d_3d.calibrate \\
        --ginc co3d_3d/configs/co3d_cls.gin \\
        --ginc co3d_3d/configs/co3d_aug3.gin \\
        --ginb 'Co3DDatasetBase.data_root = "<root>"' \\
        --samples 4 --permute 4 --out calibrated.gin
    python -m nerf_downstream_tpu_torch.co3d_3d.train --ginc ... \\
        --ginc calibrated.gin ...

It measures ``--samples`` train batches (the config's transforms and
collation, ``--batch_size`` or ``train.batch_size`` scenes each) and as
many validation batches (``train.val_batch_size``), as the training CLI's
automatic calibration does (``utils/calibrate.py``), with ``--permute``
random scene orders each and ``--slack``. The plans are built on
``--device`` (default ``cuda``, raising without a GPU).
"""

from __future__ import annotations

import argparse
import logging

from nerf_downstream_tpu_torch import config as gin


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ginc", action="append", default=[])
    parser.add_argument("--ginb", action="append", default=[])
    parser.add_argument("--samples", type=int, default=4)
    parser.add_argument("--permute", type=int, default=4)
    parser.add_argument("--slack", type=float, default=1.2)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--out", default="calibrated.gin")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    gin.parse_config_files_and_bindings(args.ginc, args.ginb)
    from nerf_downstream_tpu_torch.data.data_module import DataModule
    from nerf_downstream_tpu_torch.utils import calibrate as C

    q = gin.query_parameter
    batch_size = args.batch_size or q("train.batch_size", default=8)
    dm = DataModule(batch_size=int(batch_size),
                    val_batch_size=int(q("train.val_batch_size", default=6)),
                    capacity=q("train.capacity", default=None))
    it = dm.train_batches()
    batches = [next(it) for _ in range(args.samples)]
    batches += [b for _, b in zip(range(args.samples), dm.val_batches())]
    knobs = C.calibrate(
        batches,
        tile=int(q("CoordinateContext.window_tile", default=256)),
        window=int(q("CoordinateContext.window_size", default=128)),
        permutations=args.permute, slack=args.slack, device=args.device,
    )
    text = C.gin_text(knobs)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
