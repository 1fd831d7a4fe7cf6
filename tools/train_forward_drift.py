#!/usr/bin/env python3
"""Where a train-mode forward of ``chip_smoke.py``'s ``models_extra``
models moves between runs, module by module, on the card and on the CPU.

    python3 tools/train_forward_drift.py [--model EncodedRes16UNet]
        [--card-procs 3] [--cpu-threads 8,1]
        [--smoke-procs 0] [--out drift.json]

The model, weights and batch are those of phase ``models_extra``: the
model at its factory widths (``chip_smoke.EXTRA_MODELS``: its route and
output channels), weights from the phase's seed, the ``serving_8k``
request of numpy seed 2, f32 with TF32 off. Every run is a fresh process
that records the output rows of every module in one train-mode forward
(forward hooks), and for every train-mode ``MaskedBatchNorm`` how its
input conditions the one-pass variance that it computes:

- ``cpu<T>`` (``cpu<T>_<i>`` for the i-th entry of ``--cpu-threads``
  after the first): on the CPU at T torch threads, twice in the process
  (the second forward from a fresh copy of the model);
- ``card<i>``: on the card, in process i: the first forward of the
  process (``clean``), a second from a fresh copy (``repeat``), and one
  after the caching allocator was filled with NaN (``nan``) and one
  after it was filled with large random values (``junk``), so that a
  read of memory that nothing wrote shows;
- ``smoke<i>`` (``--smoke-procs``): on the card, in a process that first
  runs the phases ``chip_smoke.py`` runs ahead of models_extra, then
  that phase itself (its gaps, or its error, are reported), then
  records as ``card<i>`` does (``clean``, ``repeat``).

The parent compares every record with the first CPU record (the reference
of the phase's gate) and with ``card0/clean``, over each module's valid
rows, and counts non-finite padding rows. It prints one JSON object: for
every record its final output's gap to the CPU's (of the largest
output), the first module that is not bit-equal to ``card0/clean`` and
to the first CPU record, and the modules whose gap to the CPU grows the
most; and the train-mode BatchNorms whose one-pass variance is worst
conditioned. ``--out`` also gets every module's gaps. The card's name
and power limit lead the output. Needs one GPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_model(name: str, device: str):
    """The phase's model on ``device``, its weights from the phase's seed,
    and the request as a PointField there (f32, TF32 off)."""
    import torch

    import chip_smoke as cs
    from nerf_downstream_tpu_torch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = serve.make_batch("serving_8k", np.random.default_rng(2))
    model, field, _ = cs.extra_model(name, list(cs.EXTRA_MODELS).index(name),
                                     device, batch)
    return model, field


def smoke_prefix(card: str):
    """The phases that ``chip_smoke.py`` runs ahead of models_extra, in
    its order, in this process."""
    import torch

    import chip_smoke as cs

    cs.phase_serve(card, {"serving_8k": cs.SERVE_REQUESTS,
                          "eval_64k": cs.EVAL_BATCHES}, torch.bfloat16)
    cs.phase_profile("serving_8k", 3, torch.bfloat16)
    cs.phase_profile("eval_64k", 3, torch.bfloat16)
    rec = cs.record_forward("eval_64k", torch.bfloat16)
    cs.record_forward("serving_8k", torch.bfloat16)
    cs.phase_k2(rec)
    del rec
    cs.phase_model()
    cs.phase_row_route(card)


def fill_allocator(kind: str):
    """Fill most of the card's free memory, in the caching allocator's
    large and small pools, with NaN or with large random values, then free
    it to the cache, where later allocations find it."""
    import torch

    free, _ = torch.cuda.mem_get_info()
    gen = torch.Generator(device="cuda").manual_seed(7)
    held = [torch.empty(int(free * 0.6) // 4, device="cuda")]
    held += [torch.empty(1 << 16, device="cuda") for _ in range(4096)]
    for t in held:
        if kind == "nan":
            t.fill_(float("nan"))
        else:
            t.normal_(0.0, 1e3, generator=gen)
    torch.cuda.synchronize()
    del held


def child(args) -> int:
    import torch

    import chip_smoke as cs

    records, smoke = {}, None
    if args.device == "cpu":
        torch.set_num_threads(args.threads)
        model, field = build_model(args.model, "cpu")
        for tag in ("clean", "repeat"):
            records[tag] = cs.module_outputs(copy.deepcopy(model), field)
    else:
        from nerf_downstream_tpu_torch.ops.kernels import build

        build.build_all()
        tags = ("clean", "repeat", "nan", "junk")
        if args.after_smoke_phases:
            from nerf_downstream_tpu_torch.serve import card_info

            card = card_info()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            smoke_prefix(card)
            try:
                line, _ = cs.phase_models_extra(card)
                smoke = {"ok": True, "line": {
                    k: {"gap_of_max": v["gap_of_max"],
                        "train_forward_repeat_bit_identical":
                            v["train_forward_repeat_bit_identical"]}
                    for k, v in line.items() if k in cs.EXTRA_MODELS}}
            except cs.PhaseError as e:
                smoke = {"ok": False, "error": str(e)[-4000:]}
            tags = ("clean", "repeat")
        model, field = build_model(args.model, "cuda")
        for tag in tags:
            if tag in ("nan", "junk"):
                fill_allocator(tag)
            records[tag] = cs.module_outputs(copy.deepcopy(model), field)
            torch.cuda.synchronize()
    torch.save({"threads": torch.get_num_threads(), "records": records,
                "smoke": smoke}, args.dump)
    return 0


def compare(runs: dict) -> dict:
    import torch

    from chip_smoke import rows_gap

    first_cpu = next(k for k in runs if k.startswith("cpu"))
    ref = runs[first_cpu]
    base = runs.get("card0/clean", ref)
    order = list(ref)
    summary, per_module = {}, {}
    for tag, rec in runs.items():
        gaps = {}
        first_off_base = first_off_cpu = None
        bad_padding = {}
        for key in order:
            e, r = rec.get(key), ref[key]
            if e is None or e["rows"].shape != r["rows"].shape:
                gaps[key] = None
                continue
            m = r["mask"]
            gaps[key] = rows_gap(e["rows"], r["rows"], m)
            rows_eq = (torch.equal(e["rows"][m], base[key]["rows"][m])
                       if m is not None else
                       torch.equal(e["rows"], base[key]["rows"]))
            if not rows_eq and first_off_base is None:
                first_off_base = key
            if gaps[key] != 0.0 and first_off_cpu is None:
                first_off_cpu = key
            if m is not None:
                pad = e["rows"][~m]
                nf = int((~torch.isfinite(pad)).any(1).sum())
                if nf:
                    bad_padding[key] = nf
        steps = []
        prev = 0.0
        for key in order:
            g = gaps[key]
            if g is None:
                continue
            if prev > 0 and g > 4 * prev:
                steps.append((g / prev, key, prev, g))
            prev = max(prev, g) if g > 0 else prev
        steps.sort(reverse=True)
        summary[tag] = {
            "output_gap_to_cpu": gaps["<output>#1"],
            "max_abs_output": float(rec["<output>#1"]["rows"][
                rec["<output>#1"]["mask"]].abs().max()),
            "largest_gap_to_cpu": max((g for g in gaps.values()
                                       if g is not None), default=0.0),
            "first_module_not_bit_equal_to_card0_clean": first_off_base,
            "first_module_not_bit_equal_to_cpu": first_off_cpu,
            "modules_with_nonfinite_padding_rows": len(bad_padding),
            "nonfinite_padding_rows_first": dict(list(bad_padding.items())
                                                 [:5]),
            "largest_gap_growth": [
                {"module": k, "growth": s, "gap_before": p, "gap": g}
                for s, k, p, g in steps[:5]]}
        per_module[tag] = gaps
    bns = sorted(((e["bn"]["condition"], k, e["bn"]) for k, e in ref.items()
                  if "bn" in e), key=lambda t: t[0], reverse=True)
    card_bn = {k: e["bn"] for k, e in base.items() if "bn" in e}
    worst = [dict(module=k, cpu=b, card=card_bn.get(k)) for _, k, b in bns[:6]]
    return {"summary": summary, "worst_conditioned_batch_norms": worst,
            "batch_norms": len(bns), "modules": len(order),
            "per_module_gap_to_cpu": per_module}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="EncodedRes16UNet")
    ap.add_argument("--card-procs", type=int, default=3)
    ap.add_argument("--cpu-threads", default="8,1")
    ap.add_argument("--smoke-procs", type=int, default=0,
                    help="card processes that first run the phases "
                         "chip_smoke.py runs ahead of models_extra, then "
                         "that phase, then record as the others")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--threads", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--dump", default="", help=argparse.SUPPRESS)
    ap.add_argument("--after-smoke-phases", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args)

    import torch

    if not torch.cuda.is_available():
        print("train_forward_drift: no CUDA device is visible",
              file=sys.stderr)
        return 2
    from nerf_downstream_tpu_torch.ops.kernels import build
    from nerf_downstream_tpu_torch.serve import card_info

    card = card_info()
    print(card, flush=True)
    build.build_all()
    jobs = [(f"cpu{t}" + (f"_{i}" if i else ""),
             ["--device", "cpu", "--threads", t])
            for i, t in enumerate(args.cpu_threads.split(","))]
    jobs += [(f"card{i}", ["--device", "cuda"])
             for i in range(args.card_procs)]
    jobs += [(f"smoke{i}", ["--device", "cuda", "--after-smoke-phases"])
             for i in range(args.smoke_procs)]
    runs, threads, smoke = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in jobs:
            dump = os.path.join(tmp, f"{name}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", "--model", args.model, "--dump", dump,
                            *extra], check=True, cwd=REPO)
            got = torch.load(dump, weights_only=False)
            threads[name] = got["threads"]
            if got["smoke"] is not None:
                smoke[name] = got["smoke"]
            for tag, rec in got["records"].items():
                runs[f"{name}/{tag}"] = rec
            os.remove(dump)
    result = compare(runs)
    result.update(card=card, model=args.model, torch_threads=threads,
                  cpu_count=os.cpu_count(), models_extra_in_smoke=smoke)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    result.pop("per_module_gap_to_cpu")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
