#!/usr/bin/env python3
"""Time the port's ``train_64k`` training step of two checkouts on one card.

    python3 tools/compare_train_step.py parent=/path/a change=/path/b \\
        [--order parent,change,change,parent] [--deterministic-mode] \\
        [--out result.json]

Each run is a fresh process in its checkout (``python -c``, the checkout
on ``sys.path``): Res16UNet18A at ``train_64k`` (bf16) through
``train3d``, 3 warm-up steps, then 10 timed steps (host clock around a
synchronise), and a ``torch.profiler`` profile of 2 more (device time and
device ops per step, the largest device kernels). Before timing, each run
takes two steps from two fresh states of the same seed, at ``train_64k``
in bf16 and at ``train_8k`` in f32, and reports whether each pair is
bit-identical (loss, gradients, updated weights). ``--deterministic-mode``
runs every step under ``torch.use_deterministic_algorithms(True)``. The
card's name and power limit lead the output; one JSON line per run
follows. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = r'''
import json, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
from torch.profiler import ProfilerActivity, profile
from nerf_downstream_tpu_torch import serve, train3d

torch.backends.cuda.matmul.allow_tf32 = False
det = sys.argv[1] == "1"


def step(task, state, batch):
    torch.use_deterministic_algorithms(det)
    try:
        return train3d.train_step(task, state, batch)
    finally:
        torch.use_deterministic_algorithms(False)


def repeat_equal(preset, dtype, seed):
    batch = serve.to_device(train3d.make_batch(preset, np.random.default_rng(seed)), "cuda")
    runs = []
    for _ in range(2):
        task, st = train3d.build_training("Res16UNet18A", preset, device="cuda", seed=0,
                                          compute_dtype=dtype)
        st, m = step(task, st, batch)
        runs.append([m["loss"]] + [p.grad.clone() for p in st.model.parameters()]
                    + [p.detach().clone() for p in st.model.parameters()])
    return all(torch.equal(a, b) for a, b in zip(*runs))


repro = {"train_64k_bf16": repeat_equal("train_64k", torch.bfloat16, 0),
         "train_8k_f32": repeat_equal("train_8k", torch.float32, 1)}
task, state = train3d.build_training("Res16UNet18A", "train_64k", device="cuda", seed=0)
batch = serve.to_device(train3d.make_batch("train_64k", np.random.default_rng(0)), "cuda")
for _ in range(3):
    state, m = step(task, state, batch)
ms = []
for _ in range(10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(task, state, batch)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(2):
        state, m = step(task, state, batch)
    torch.cuda.synchronize()
dev, ops, top = 0.0, 0.0, []
for r in prof.key_averages():
    if r.device_type != torch.autograd.DeviceType.CUDA:
        continue
    us = getattr(r, "self_device_time_total", None) or r.self_cuda_time_total
    dev += us / 1e3 / 2
    ops += r.count / 2
    top.append((us / 1e3 / 2, r.key[:80]))
top.sort(reverse=True)
print(json.dumps({"ms": ms, "median": float(np.median(ms)), "device_ms": dev,
                  "device_ops": ops, "loss": float(m["loss"]),
                  "bit_identical_repeat_steps": repro, "top": top[:6]}))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="name=checkout directory")
    ap.add_argument("--order", default=None,
                    help="comma-separated names (default: a, b, b, a)")
    ap.add_argument("--deterministic-mode", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.trees)
    names = list(trees)
    order = (args.order.split(",") if args.order
             else names[:1] + names[1:] * 2 + names[:1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    out = {"card": card, "deterministic_mode": args.deterministic_mode}
    for i, name in enumerate(order):
        r = subprocess.run(
            [sys.executable, "-c", CHILD,
             "1" if args.deterministic_mode else "0"],
            cwd=trees[name], capture_output=True, text=True)
        lines = r.stdout.strip().splitlines()
        res = (json.loads(lines[-1]) if r.returncode == 0 and lines
               else {"rc": r.returncode, "stderr": r.stderr[-2000:]})
        out[f"{i}_{name}"] = res
        print(json.dumps({f"{i}_{name}": res}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if all("rc" not in v for k, v in out.items()
                    if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
