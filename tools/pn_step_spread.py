#!/usr/bin/env python3
"""How far a whole-model PowerNorm training step on the card lies from the
CPU's, over several seeds: the spread that ``chip_smoke.py``'s ``norms``
phase sets its PowerNorm step limits from.

    python3 tools/pn_step_spread.py [--seeds 0,1,2,3]

For each seed: one ``eval_64k`` batch and Res16UNet18A at full width
(f32, TF32 off) with weights drawn from the seed, as ``phase_norms``
builds them. Runs the BatchNorm step comparison (``bn_step_worst``) and
the two PowerNorm steps with their control (``pn_steps``: the second
step from a nonzero ``ema_gz``, the control that step on the CPU without
the backward's EMA correction), and prints one JSON line per seed with
the worst ``ema_gz``, ``running_phi`` and weight gaps of each, then one
line with the largest of each over the seeds, beside the card's name
and power limit. Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from nerf_downstream_tpu_torch import serve
    from nerf_downstream_tpu_torch.ops.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pn_step_spread: no GPU", file=sys.stderr)
        return 1
    build.build_all()  # every kernel at once, before the first step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = serve.card_info()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        host = serve.make_batch("eval_64k", np.random.default_rng(seed))
        batch = {"cuda": serve.to_device(host, "cuda"),
                 "cpu": serve.to_device(host, "cpu")}
        gpu, variables = cs.norm_model("BN", "cuda", seed=seed)
        cpu, _ = cs.norm_model("BN", "cpu", variables)
        bn = cs.bn_step_worst(gpu, cpu, batch)
        gpu, variables = cs.norm_model("PN", "cuda", seed=seed)
        cpu, _ = cs.norm_model("PN", "cpu", variables)
        steps = cs.pn_steps(gpu, cpu, batch)
        row = {"seed": seed, "bn_weights": bn,
               "loss_relative": steps["loss"]["relative"],
               "two_steps_bit_identical": steps["two_steps_bit_identical"],
               "ema_gz_max_after_step1": steps["ema_gz_max_after_step1"]}
        for k in ("step1", "step2", "control_no_correction"):
            row[k] = {n: steps[k][n]
                      for n in ("ema_gz", "running_phi", "weights")}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del gpu, cpu
        torch.cuda.empty_cache()

    def worst(key, kind):
        return max(r[key][kind][1] for r in rows)

    summary = {"seeds": [r["seed"] for r in rows],
               "bn_weights": max(r["bn_weights"][1] for r in rows),
               "card": card}
    for key in ("step1", "step2"):
        summary[key] = {n: worst(key, n)
                        for n in ("ema_gz", "running_phi", "weights")}
    summary["control_least"] = {
        n: min(r["control_no_correction"][n][1] for r in rows)
        for n in ("ema_gz", "weights")}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
