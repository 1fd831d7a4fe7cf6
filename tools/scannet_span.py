#!/usr/bin/env python3
"""How often ``scannet_semseg.gin``'s train augmentation takes a room past
its ``CoordinateContext.grid_extent`` (384 voxels), where
``collate_mink`` raises.

    python3 tools/scannet_span.py [--extent 3.0,6.5] [--rooms 6]
        [--draws 5] [--vertices 20000] [--seed 0]

Writes ``--rooms`` synthetic ScanNet rooms with floor sides drawn from
``--extent`` metres (``data.synthetic.write_scannet_ply_tree``) into a
temporary directory, reads each ``--draws`` times through
``ScannetDataset("train")`` under the config unchanged but the data root
(the host transforms seeded from ``--seed``), and prints one JSON line:
the largest coordinate span in voxels and the share of samples whose span
reaches the grid extent. Runs on the host; no GPU is needed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> dict:
    from nerf_downstream_tpu_torch import config as cfg
    from nerf_downstream_tpu_torch.data import transforms as T
    from nerf_downstream_tpu_torch.data.scannet import ScannetDataset
    from nerf_downstream_tpu_torch.data.synthetic import (
        write_scannet_ply_tree,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--extent", default="3.0,6.5")
    ap.add_argument("--rooms", type=int, default=6)
    ap.add_argument("--draws", type=int, default=5)
    ap.add_argument("--vertices", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    extent = tuple(float(x) for x in args.extent.split(","))
    config = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "co3d_3d", "configs",
        "scannet_semseg.gin")
    with tempfile.TemporaryDirectory() as tmp:
        root = write_scannet_ply_tree(
            tmp, np.random.default_rng(args.seed), n_train=args.rooms,
            n_val=0, n_vertices=args.vertices, extent=extent)
        cfg.clear_config()
        cfg.parse_config_files_and_bindings(
            [config], [f'ScannetDataset.data_root = "{root}"'])
        grid = cfg.query_parameter("CoordinateContext.grid_extent")
        T.seed(args.seed)
        ds = ScannetDataset("train")
        spans = np.array([
            float(np.ptp(ds[i]["coordinates"], axis=0).max())
            for _ in range(args.draws) for i in range(len(ds))])
    out = {"extent_m": extent, "grid_extent": grid,
           "samples": int(spans.size), "max_span": float(spans.max()),
           "share_reaching_grid_extent": float((spans >= grid).mean())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
