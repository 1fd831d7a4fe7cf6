#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path (Res16UNet18A sparse-voxel serving through
``nerf_downstream_tpu_torch.serve``) on the card at full width, with the
hand-written CUDA kernels K1 ``window_match`` and K2
``window_gather_matmul``, and holds every kernel against its plain
PyTorch version on the inputs the main path gives it. Phases:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the kernels from the sources in the checkout (timed);
3. serve: ``serving_8k`` (1 scene, 8k rows) for 5 requests and
   ``eval_64k`` (8 scenes, 64k rows) for 3 batches in bf16, launch counts
   reset just before and read just after; every logit finite;
   then a profile of 3 more requests of each preset (torch.profiler):
   host wall time against the device time of every kernel;
4. k1: K1 against its plain version on every plan of one eval_64k
   forward, exact equality;
5. k2: K2 against its plain version at every call of one eval_64k
   forward: in f32 within atol = rtol = 1e-5; in bf16 against the plain
   version in f32 within rtol = 2^-8, atol = 1e-5 (one rounding of the
   f32 sum into bf16 is at most 2^-9 relative; the rest covers the
   order of f32 sums); the C = 27 stem conv against the same call with
   Cin zero-padded to 32 (must be identical);
6. model: whole-model logits of the kernel path against the plain path,
   both f32 on the card, ``serving_8k``, within 1e-4 relative to the
   largest logit;
7. the ``kernels`` line, the card line, and the ``ok`` line.

Every phase prints one JSON line; any failure exits non-zero without the
``ok`` line. Without a GPU, or without the package beside this file, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SERVE_REQUESTS = 5
EVAL_BATCHES = 3
K2_F32_TOL = 1e-5
K2_BF16_RTOL = 2.0 ** -8
K2_BF16_ATOL = 1e-5
MODEL_TOL = 1e-4
# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# FLOP/s of the bf16 tensor cores and of f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


class PhaseError(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def device_rows(prof, n: int) -> list[tuple[float, float, str]]:
    """(ms, count, name) per request of every device activity a profile
    saw, longest first."""
    import torch

    rows = []
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(row, "self_device_time_total", None)
        if us is None:
            us = row.self_cuda_time_total
        rows.append((us / 1e3 / n, row.count / n, row.key))
    return sorted(rows, reverse=True)


def device_ms(fn, reps: int = 5) -> float:
    """Device time of ``fn`` in ms per call, launches back to back: the
    stream is held busy (``torch.cuda._sleep``) while the host enqueues
    ``reps`` calls between two CUDA events, so the host's cost of
    launching them does not leave gaps in the measured span."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # >= 3x the enqueue time at up to 2 GHz SM clock, plus 2 ms
    torch.cuda._sleep(int(2e9 * (3 * reps * host_s + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Records the inputs of every K1 and K2 call of a forward (and the
    window blocks of each windowed conv's plan), by wrapping the names the
    package's modules call. Calls go on to the real wrappers."""

    def __init__(self):
        self.k1: list[tuple] = []
        self.k2: list[tuple] = []
        self.blocks: list[int] = []

    def __enter__(self):
        from nerf_downstream_tpu_torch.models.mink import layers
        from nerf_downstream_tpu_torch.ops import window_conv

        self._saved = (window_conv.window_match,
                       window_conv.window_gather_matmul,
                       layers.window_conv_apply)
        match, gmm, apply = self._saved

        def rec_match(*args):
            self.k1.append(tuple(a.clone() if hasattr(a, "clone") else a
                                 for a in args))
            return match(*args)

        def rec_gmm(feats, starts, idx, w):
            self.k2.append((feats.clone(), starts.clone(), idx.clone(),
                            w.clone()))
            return gmm(feats, starts, idx, w)

        def rec_apply(feats, plan, *args, **kwargs):
            self.blocks.append(plan.blocks)
            return apply(feats, plan, *args, **kwargs)

        window_conv.window_match = rec_match
        window_conv.window_gather_matmul = rec_gmm
        layers.window_conv_apply = rec_apply
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.models.mink import layers
        from nerf_downstream_tpu_torch.ops import window_conv

        (window_conv.window_match, window_conv.window_gather_matmul,
         layers.window_conv_apply) = self._saved
        return False


class PlainPath:
    """Routes the model's kernel calls to the plain PyTorch versions (the
    reference side of the whole-model comparison on the card)."""

    def __enter__(self):
        from nerf_downstream_tpu_torch.ops import window_conv
        from nerf_downstream_tpu_torch.ops.kernels import (
            window_gather_matmul_plain,
            window_match_plain,
        )

        self._saved = (window_conv.window_match,
                       window_conv.window_gather_matmul)
        window_conv.window_match = window_match_plain
        window_conv.window_gather_matmul = window_gather_matmul_plain
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.ops import window_conv

        (window_conv.window_match,
         window_conv.window_gather_matmul) = self._saved
        return False


def k1_bytes(args) -> int:
    """Bytes K1 must move: the key table and the query keys and mask read
    once, starts and deltas read once, idx written once."""
    hi, lo, o_hi, o_lo, out_mask, deltas, starts = args[:7]
    tile = args[7]
    g, nt = starts.shape
    m = deltas.shape[1]
    return int(8 * hi.numel() + 9 * o_hi.numel() + 4 * starts.numel()
               + 4 * deltas.numel() + 4 * g * nt * m * tile)


def k2_work(feats, starts, idx, w) -> tuple[int, int]:
    """(bytes, FLOPs) K2 must spend on these inputs: every feature row and
    weight read once, idx and starts read once, the output written once;
    2 C Cout operations per present entry of idx."""
    g, nt, m, tile = idx.shape
    c, cout = w.shape[-2], w.shape[-1]
    present = int((idx >= 0).sum())
    nbytes = (feats.numel() * feats.element_size()
              + w.numel() * w.element_size() + 4 * idx.numel()
              + 4 * starts.numel() + nt * tile * cout * feats.element_size())
    return int(nbytes), 2 * c * cout * present


def phase_build() -> dict:
    from nerf_downstream_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    for stem in libs:
        build.library(stem)
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "libraries": sorted(os.path.basename(p) for p in libs.values()),
            "ptxas": {k: [ln.strip() for ln in v.splitlines()
                          if "registers" in ln or "spill" in ln]
                      for k, v in build.ptxas_report().items()}}


def phase_serve(card: str, requests: dict, dtype) -> tuple[dict, dict]:
    """The main path: each preset's model answers its requests through the
    serve entry points. Returns (phase line, launch counts)."""
    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import serve
    from nerf_downstream_tpu_torch.ops import kernels

    out = {"phase": "serve", "card": card, "dtype": str(dtype), "presets": {}}
    launches = {name: 0 for name in kernels.launch_counts()}
    for preset, n in requests.items():
        model = serve.build_segmenter("Res16UNet18A", ctx_preset=preset,
                                      device="cuda", seed=0,
                                      compute_dtype=dtype)
        rng = np.random.default_rng(0)
        batches = [serve.to_device(serve.make_batch(preset, rng), "cuda")
                   for _ in range(n)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        times, rows = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, mets = serve.eval_step(model, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            valid = batch["mask"]
            if logits.shape != (valid.shape[0], serve.NUM_CLASSES):
                raise PhaseError(f"{preset}: logits shape {logits.shape}")
            if not bool(torch.isfinite(logits[valid]).all()):
                raise PhaseError(f"{preset}: non-finite logits")
            if not bool(torch.isfinite(mets["loss"])):
                raise PhaseError(f"{preset}: non-finite loss")
            rows.append(int(valid.sum()))
        counts = kernels.launch_counts()
        for name, c in counts.items():
            if c <= 0:
                raise PhaseError(f"{preset}: kernel {name} never launched")
            launches[name] += c
        out["presets"][preset] = {
            "requests": n, "valid_rows": rows, "ms": times,
            "ms_median_after_first": float(np.median(times[1:])),
            "launches": counts,
            "launches_per_request": {k: v / n for k, v in counts.items()},
        }
    return out, launches


def phase_profile(preset: str, n: int, dtype) -> dict:
    """Where a request's time goes: host wall time against the device time
    of every kernel (torch.profiler, CUPTI), per request, after warmup."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_downstream_tpu_torch import serve

    model = serve.build_segmenter("Res16UNet18A", ctx_preset=preset,
                                  device="cuda", seed=0, compute_dtype=dtype)
    rng = np.random.default_rng(2)
    batches = [serve.to_device(serve.make_batch(preset, rng), "cuda")
               for _ in range(n)]
    serve.eval_step(model, batches[0])

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            serve.eval_step(model, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    wall = run()  # the same requests without the profiler's overhead
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_profiled = run()
    rows = device_rows(prof, n)
    device = sum(r[0] for r in rows)
    if device <= 0:
        raise PhaseError("the profiler saw no device time")
    return {"phase": "profile", "preset": preset, "dtype": str(dtype),
            "requests": n, "wall_ms_per_request": wall,
            "wall_ms_per_request_profiled": wall_profiled,
            "device_ms_per_request": device,
            "device_busy_share": device / wall,
            "device_ops_per_request": sum(r[1] for r in rows),
            "top_device": [{"name": k[:90], "per_request": c, "ms": ms}
                           for ms, c, k in rows[:12]]}


def record_forward(preset: str, dtype):
    """One forward of ``preset`` with every kernel call recorded."""
    import numpy as np

    from nerf_downstream_tpu_torch import serve

    model = serve.build_segmenter("Res16UNet18A", ctx_preset=preset,
                                  device="cuda", seed=0, compute_dtype=dtype)
    batch = serve.to_device(
        serve.make_batch(preset, np.random.default_rng(0)), "cuda")
    with Recorder() as rec:
        serve.eval_step(model, batch)
    if len(rec.k2) != len(rec.blocks):
        raise PhaseError("K2 calls and windowed convs do not pair up")
    return rec


def phase_k1(rec) -> tuple[dict, dict]:
    from nerf_downstream_tpu_torch.ops.kernels import (
        window_match,
        window_match_plain,
    )

    plans, kernel_ms, plain_ms, bound_ms = [], 0.0, 0.0, 0.0
    for args in rec.k1:
        got = window_match(*args)
        want = window_match_plain(*args)
        n_diff = int((got != want).sum())
        hi, _, o_hi, _, _, deltas, starts, tile, window, blocks = args
        kind = ("same-set" if o_hi.shape == hi.shape
                and bool((o_hi == hi).all()) else "cross")
        t_k = device_ms(lambda: window_match(*args))
        t_p = device_ms(lambda: window_match_plain(*args), reps=2)
        b = k1_bytes(args) / HBM_BYTES_PER_S * 1e3
        kernel_ms, plain_ms, bound_ms = (kernel_ms + t_k, plain_ms + t_p,
                                         bound_ms + b)
        plans.append({
            "kind": kind, "n_in": hi.shape[0], "n_out": o_hi.shape[0],
            "G": starts.shape[0], "M": deltas.shape[1], "tile": tile,
            "coverage": blocks * window, "mismatches": n_diff,
            "present": int((got >= 0).sum()), "ms": t_k, "plain_ms": t_p,
            "bound_ms": b,
        })
        if n_diff:
            raise PhaseError(f"K1 differs from its plain version: {plans[-1]}")
    line = {"phase": "k1", "plans": plans, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms}
    return line, {"max_abs_err": 0, "ms": kernel_ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "calls_per_forward": len(plans)}


def phase_k2(rec) -> tuple[dict, dict]:
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        window_gather_matmul,
        window_gather_matmul_plain,
    )

    shapes: dict = {}
    err32 = err16 = 0.0
    kernel_ms = plain_ms = bound_ms = 0.0
    pad_checked = False
    for (feats, starts, idx, w), blocks in zip(rec.k2, rec.blocks):
        g, nt, m, tile = idx.shape
        c, cout = w.shape[-2], w.shape[-1]
        key = (c, cout, g, m, tile, blocks)
        # f32: the kernel against the plain version on the same inputs
        f32, w32 = feats.float(), w.float()
        got = window_gather_matmul(f32, starts, idx, w32)
        want = window_gather_matmul_plain(f32, starts, idx, w32)
        d32 = (got - want).abs()
        bad32 = int((d32 > K2_F32_TOL + K2_F32_TOL * want.abs()).sum())
        # the working type: bf16 in and out, against the plain f32 sum
        got16 = window_gather_matmul(feats, starts, idx, w)
        d16 = (got16.float() - want).abs()
        bad16 = int((d16 > K2_BF16_ATOL + K2_BF16_RTOL * want.abs()).sum())
        err32 = max(err32, float(d32.max()))
        err16 = max(err16, float(d16.max()))
        if c == 27:
            # stem conv: Cin zero-padded to 32 must leave the output as is
            fp = torch.nn.functional.pad(feats, (0, 5))
            wp = torch.nn.functional.pad(w, (0, 0, 0, 5))
            padded = window_gather_matmul(fp.contiguous(), starts, idx,
                                          wp.contiguous())
            if not torch.equal(padded, got16):
                raise PhaseError("K2 at C=27 differs from its Cin-padded run")
            pad_checked = True
        t_k = device_ms(lambda: window_gather_matmul(feats, starts, idx, w))
        t_p = device_ms(lambda: window_gather_matmul_plain(feats, starts,
                                                           idx, w), reps=2)
        nbytes, flops = k2_work(feats, starts, idx, w)
        peak = PEAK_FLOPS[str(feats.dtype).replace("torch.", "")]
        b = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
        kernel_ms, plain_ms, bound_ms = (kernel_ms + t_k, plain_ms + t_p,
                                         bound_ms + b)
        s = shapes.setdefault(str(key), {
            "C": c, "Cout": cout, "G": g, "M": m, "tile": tile,
            "blocks": blocks, "calls": 0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": None, "max_err_f32": 0.0,
            "max_err_bf16": 0.0, "present": 0, "entries": 0,
        })
        s["calls"] += 1
        s["ms"] += t_k
        s["plain_ms"] += t_p
        s["bound_ms"] += b
        s["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / peak else "operations")
        s["max_err_f32"] = max(s["max_err_f32"], float(d32.max()))
        s["max_err_bf16"] = max(s["max_err_bf16"], float(d16.max()))
        s["present"] += int((idx >= 0).sum())
        s["entries"] += idx.numel()
        if bad32 or bad16:
            raise PhaseError(f"K2 outside tolerance at {s}: {bad32} f32 and "
                             f"{bad16} bf16 elements")
    if not pad_checked:
        raise PhaseError("no C=27 call was recorded")
    line = {"phase": "k2", "shapes": list(shapes.values()),
            "max_abs_err_f32": err32, "max_abs_err_bf16": err16,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "tolerance": {"f32": [K2_F32_TOL, K2_F32_TOL],
                          "bf16": [K2_BF16_ATOL, K2_BF16_RTOL]}}
    by_bytes = sum(s["bound_ms"] for s in shapes.values()
                   if s["bound_by"] == "bytes")
    return line, {"max_abs_err": err32, "max_abs_err_bf16": err16,
                  "ms": kernel_ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms,
                  "bound_by": ("bytes" if by_bytes >= bound_ms / 2
                               else "operations"),
                  "calls_per_forward": len(rec.k2)}


def phase_model() -> dict:
    """Whole-model logits, kernel path against plain path, f32 on the card."""
    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import serve

    model = serve.build_segmenter("Res16UNet18A", ctx_preset="serving_8k",
                                  device="cuda", seed=0,
                                  compute_dtype=torch.float32)
    batch = serve.to_device(
        serve.make_batch("serving_8k", np.random.default_rng(1)), "cuda")
    logits, _ = serve.eval_step(model, batch)
    with PlainPath():
        ref, _ = serve.eval_step(model, batch)
    valid = batch["mask"]
    scale = float(ref[valid].abs().max())
    err = float((logits[valid] - ref[valid]).abs().max())
    agree = float((logits[valid].argmax(-1) == ref[valid].argmax(-1))
                  .float().mean())
    line = {"phase": "model", "preset": "serving_8k", "dtype": "float32",
            "max_abs_err": err, "max_abs_logit": scale,
            "argmax_agreement": agree, "tolerance": MODEL_TOL * scale}
    if not (np.isfinite(err) and err <= MODEL_TOL * scale):
        raise PhaseError(f"model logits disagree: {line}")
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    try:
        import nerf_downstream_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nerf_downstream_tpu_torch.serve import card_info

    phase = "device"
    try:
        card = card_info()
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "nvidia_smi": card,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        phase = "build"
        emit(phase_build())
        phase = "serve"
        line, launches = phase_serve(
            card, {"serving_8k": SERVE_REQUESTS, "eval_64k": EVAL_BATCHES},
            torch.bfloat16)
        emit(line)
        phase = "profile"
        emit(phase_profile("serving_8k", 3, torch.bfloat16))
        emit(phase_profile("eval_64k", 3, torch.bfloat16))
        phase = "record"
        rec = record_forward("eval_64k", torch.bfloat16)
        phase = "k1"
        line, k1 = phase_k1(rec)
        emit(line)
        phase = "k2"
        line, k2 = phase_k2(rec)
        emit(line)
        del rec
        phase = "model"
        emit(phase_model())
    except Exception as e:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        raise
    kernels = [
        dict(name="window_match", route="cuda",
             source="nerf_downstream_tpu_torch/ops/kernels/window_match.cu",
             replaces="nerf_downstream_tpu/ops/pallas/window_gather.py:387",
             launches=launches["window_match"], bound_by="bytes",
             library_ms=None, shapes="one eval_64k forward (bf16)", **k1),
        dict(name="window_gather_matmul", route="cuda",
             source=("nerf_downstream_tpu_torch/ops/kernels/"
                     "window_gather_matmul.cu"),
             replaces="nerf_downstream_tpu/ops/pallas/window_gather.py:131",
             launches=launches["window_gather_matmul"], library_ms=None,
             shapes="one eval_64k forward (bf16)", **k2),
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
