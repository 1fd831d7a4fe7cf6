#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's two main paths on the card at full width: Res16UNet18A
sparse-voxel serving (``nerf_downstream_tpu_torch.serve``) and its
training step (``nerf_downstream_tpu_torch.train3d``), with the
hand-written CUDA kernels K1 ``window_match``, K2 ``window_gather_matmul``
(forward), K3 ``window_bwd`` and K4 ``window_dw`` (backward), and holds
every kernel against its plain PyTorch version on the inputs the main
paths give it. Phases:

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
7. train: ``train_64k`` (8 scenes, 64k rows, device augmentation, bf16)
   for 5 SGD steps through ``train3d``, launch counts reset just before
   and read just after (41 K3 and 1 K4 launches per step); every loss
   finite and all distinct; then a profile of 2 more steps; and the
   device augmentation against its distribution (per-scene gate rates of
   the jitter and the elastic warp, the jitter's noise moments);
8. k3 / k4: every K3 and K4 call of one more recorded step against the
   plain versions, in f32 and in bf16. d_feats: as K2 (rtol 1e-5 in f32,
   2^-8 in bf16 against the f32 plain version), with the absolute term
   scaled by the largest value (gradients of a mean loss over 62,400
   points are small). d_w is an f32 sum over up to 65,536 rows whose
   plain version takes the same inputs (bf16 ones cast up exactly), so
   only the order and fusing of the f32 sums differs: within 1e-5 x
   max|d_w| of each (g, m).
   K3's d_w against K4's over the forward plan within the same bound;
   whether two launches on the same inputs give bit-identical results;
9. train_model: one f32 ``train_8k`` step (one scene at 8k rows),
   kernel path against plain path: the loss within 1e-5 relative and the
   running statistics within 1e-4 relative and 1e-5 absolute, from whole
   steps, against the plain path and against the kernel path's own
   repeat; every parameter's gradient within 1e-4 x its largest and the
   parameters after the SGD step within lr x that bound + 1e-6 x
   (1 + |p|), from one forward graph differentiated through the kernels
   and through the plain versions. The whole steps' gradient gaps are
   reported beside a plain step whose K2 sums run in reverse order, with
   the ReLU gates each pair's forwards put on different sides (why:
   ``phase_train_model``);
10. the ``kernels`` line, the card line, and the ``ok`` line.

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
TRAIN_STEPS = 5
TRAIN_PROFILE_STEPS = 2
K3_PER_STEP, K4_PER_STEP = 41, 1
# d_feats: (rtol, atol as a fraction of the largest |value|)
DFEATS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -8, 1e-5)}
DW_TOL = 1e-5  # of max|d_w[g, m]|, per (g, m)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
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
    reference side of the whole-model comparison on the card), or to the
    functions ``override`` names."""

    NAMES = ("window_match", "window_gather_matmul", "window_bwd",
             "window_dw")

    def __init__(self, **override):
        self.override = override

    def __enter__(self):
        from nerf_downstream_tpu_torch.ops import kernels, window_conv

        self._saved = [getattr(window_conv, n) for n in self.NAMES]
        for n in self.NAMES:
            setattr(window_conv, n, self.override.get(
                n, getattr(kernels, n + "_plain")))
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.ops import window_conv

        for n, fn in zip(self.NAMES, self._saved):
            setattr(window_conv, n, fn)
        return False


def reversed_sum_gmm(feats, starts, idx, w):
    """K2's plain version with its (g, m) terms summed in reverse order:
    the same sum, rounded differently."""
    from nerf_downstream_tpu_torch.ops.kernels import (
        window_gather_matmul_plain,
    )

    return window_gather_matmul_plain(feats, starts.flip(0), idx.flip(0, 2),
                                      w.flip(0, 1))


class GateRecorder:
    """Records the valid rows' input of every activation of the models
    built inside it, by wrapping the name the model's modules call."""

    def __init__(self):
        self.inputs: list = []

    def __enter__(self):
        from nerf_downstream_tpu_torch.models.mink import blocks, res16unet

        self._mods = (blocks, res16unet)
        self._saved = [m.get_nonlinearity for m in self._mods]
        get = self._saved[0]

        def rec_get(name):
            act = get(name)

            def apply(sv):
                self.inputs.append(sv.feats[sv.mask].detach().float().clone())
                return act(sv)

            return apply

        for m in self._mods:
            m.get_nonlinearity = rec_get
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self._mods, self._saved):
            m.get_nonlinearity = fn
        return False


class TrainRecorder:
    """Records the inputs of every K3 and K4 call of a training step, with
    the forward plan of each K3 call (kept by a subclass of the conv's
    autograd Function that the recorder puts in its place). Calls go on to
    the real kernels."""

    def __init__(self):
        self.k3: list[dict] = []
        self.k4: list[tuple] = []

    def __enter__(self):
        from nerf_downstream_tpu_torch.ops import window_conv as wc

        self._saved = (wc._WindowConvCore, wc.window_dw)
        core, dw = self._saved
        rec = self

        class RecordingCore(core):
            @staticmethod
            def forward(ctx, f, w, starts, idx, inv_starts, inv_idx):
                ctx.forward_plan = (starts, idx)
                return core.forward(ctx, f, w, starts, idx, inv_starts,
                                    inv_idx)

            @staticmethod
            def backward(ctx, g):
                f, w, inv_starts, inv_idx = ctx.saved_tensors
                starts, idx = ctx.forward_plan
                rec.k3.append(dict(
                    g_out=g.detach().to(f.dtype).contiguous().clone(),
                    feats=f.detach(), inv_starts=inv_starts,
                    inv_idx=inv_idx,
                    w_t=w.detach().transpose(-1, -2).contiguous(),
                    starts=starts, idx=idx))
                return core.backward(ctx, g)

        def rec_dw(feats, starts, idx, g_out):
            self.k4.append((feats.detach(), starts, idx,
                            g_out.detach().clone()))
            return dw(feats, starts, idx, g_out)

        wc._WindowConvCore = RecordingCore
        wc.window_dw = rec_dw
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.ops import window_conv as wc

        wc._WindowConvCore, wc.window_dw = self._saved
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


def present_entries(starts, idx, n_rows: int) -> int:
    """Plan entries that name a row of an n_rows table."""
    rows = starts[:, :, None, None].long() + idx.long()
    return int(((idx >= 0) & (rows < n_rows)).sum())


def k3_work(c3) -> tuple[int, int]:
    """(bytes, FLOPs) K3 must spend: g_out, feats, w_t, the inverse plan
    read once, d_feats and d_w (f32) written once; 2 C Cout operations per
    present entry for each of d_feats and d_w."""
    g_out, feats, w_t = c3["g_out"], c3["feats"], c3["w_t"]
    es = g_out.element_size()
    g, _, m, _ = c3["inv_idx"].shape
    c, cout = feats.shape[1], g_out.shape[1]
    nbytes = (es * (g_out.numel() + 2 * feats.numel() + w_t.numel())
              + 4 * (c3["inv_idx"].numel() + c3["inv_starts"].numel())
              + 4 * g * m * c * cout)
    present = present_entries(c3["inv_starts"], c3["inv_idx"],
                              g_out.shape[0])
    return int(nbytes), 4 * c * cout * present


def k4_work(feats, starts, idx, g_out) -> tuple[int, int]:
    """(bytes, FLOPs) K4 must spend: feats, g_out and the plan read once,
    d_w (f32) written once; 2 C Cout operations per present entry."""
    es = feats.element_size()
    g, _, m, _ = idx.shape
    c, cout = feats.shape[1], g_out.shape[1]
    nbytes = (es * (feats.numel() + g_out.numel())
              + 4 * (idx.numel() + starts.numel() + g * m * c * cout))
    present = present_entries(starts, idx, feats.shape[0])
    return int(nbytes), 2 * c * cout * present


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for this work in ``dtype``."""
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dfeats_bad(got, want, dtype) -> int:
    """Elements of d_feats outside DFEATS_TOL against the f32 plain sum."""
    rtol, atol = DFEATS_TOL[str(dtype).replace("torch.", "")]
    scale = float(want.abs().max())
    return int(((got.float() - want).abs()
                > atol * scale + rtol * want.abs()).sum())


def dw_err(got, want) -> tuple[float, float]:
    """(largest |got - want| / max|want| over the (g, m) slices, largest
    |got - want|)."""
    d = (got - want).abs().flatten(2).amax(-1)
    scale = want.abs().flatten(2).amax(-1).clamp(min=1e-30)
    return float((d / scale).max()), float(d.max())


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
        for name in ("window_match", "window_gather_matmul"):
            if counts[name] <= 0:
                raise PhaseError(f"{preset}: kernel {name} never launched")
        for name, c in counts.items():
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


def phase_train(card: str, dtype) -> tuple[dict, dict, tuple]:
    """The training path: ``train_64k`` steps through ``train3d``, launch
    counts reset just before and read just after, then a profile of more
    steps. Returns (phase line, launch counts, (task, state, batch))."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_downstream_tpu_torch import serve, train3d
    from nerf_downstream_tpu_torch.ops import kernels

    task, state = train3d.build_training("Res16UNet18A", "train_64k",
                                         device="cuda", seed=0,
                                         compute_dtype=dtype)
    batch = serve.to_device(
        train3d.make_batch("train_64k", np.random.default_rng(0)), "cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mets = train3d.train_step(task, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(mets["loss"]))
    counts = kernels.launch_counts()
    line = {"phase": "train", "card": card, "preset": "train_64k",
            "dtype": str(dtype), "steps": TRAIN_STEPS,
            "valid_rows": int(batch["mask"].sum()), "ms": times,
            "ms_median_after_first": float(np.median(times[1:])),
            "losses": losses, "launches": counts,
            "launches_per_step": {k: v / TRAIN_STEPS
                                  for k, v in counts.items()}}
    if not np.isfinite(losses).all():
        raise PhaseError(f"non-finite training loss: {line}")
    if len(set(losses)) != len(losses):
        raise PhaseError(f"repeated training losses: {line}")
    want = {"window_bwd": K3_PER_STEP * TRAIN_STEPS,
            "window_dw": K4_PER_STEP * TRAIN_STEPS}
    for name, c in counts.items():
        if c <= 0 or c != want.get(name, c):
            raise PhaseError(f"kernel {name}: {c} launches in {TRAIN_STEPS} "
                             f"steps, want {want.get(name, '> 0')}")

    def run(n) -> float:
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = train3d.train_step(task, state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    n = TRAIN_PROFILE_STEPS
    wall = run(n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_profiled = run(n)
    rows = device_rows(prof, n)
    device = sum(r[0] for r in rows)
    if device <= 0:
        raise PhaseError("the profiler saw no device time")
    line["profile"] = {
        "steps": n, "wall_ms_per_step": wall,
        "wall_ms_per_step_profiled": wall_profiled,
        "device_ms_per_step": device, "device_busy_share": device / wall,
        "device_ops_per_step": sum(r[1] for r in rows),
        "top_device": [{"name": k[:90], "per_step": c, "ms": ms}
                       for ms, c, k in rows[:12]]}
    return line, counts, (task, state, batch)


def phase_augment() -> dict:
    """The device augmentation of ``train_64k`` against its distribution:
    over 32 generator seeds on the card, the share of scenes each
    transform touches (a binomial over 256 scene draws: within 4 of its
    standard deviations of the ratio) and the jitter's noise moments on
    the rows it touched ((randn - 0.5) x std: mean -std / 2 and standard
    deviation std, each within 1 % of std over millions of values)."""
    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import serve, train3d
    from nerf_downstream_tpu_torch.data import device_transforms as DT

    p = train3d.PRESETS["train_64k"]
    batch = serve.to_device(
        train3d.make_batch("train_64k", np.random.default_rng(3)), "cuda")
    jit = DT.RandomFeatureJitter()
    ed = DT.ElasticDistortion(**p["task"]["transform_params"][
        "ElasticDistortion"], max_extent=p["grid_extent"],
        num_scenes=p["scenes"])
    scene = batch["coordinates"][:, 0].long()
    valid = batch["mask"]
    s, w = jit.start_ind, jit._width(batch["features"])
    seeds, touched = 32, {"jitter": [], "elastic": []}
    deltas = []
    for seed in range(seeds):
        gen = torch.Generator(device=valid.device)
        gen.manual_seed(seed)
        out = jit(batch, gen)["features"]
        moved = ed(batch, gen)["coordinates"]
        for name, changed in (
                ("jitter", (out != batch["features"]).any(1)),
                ("elastic", (moved != batch["coordinates"]).any(1))):
            touched[name] += [bool(changed[valid & (scene == b)].any())
                              for b in range(p["scenes"])]
        on = (out != batch["features"]).any(1) & valid
        deltas.append((out - batch["features"])[on][:, s:s + w].flatten())
    d = torch.cat(deltas).double()
    mean, sd = float(d.mean()) / jit.std, float(d.std()) / jit.std
    line = {"phase": "augment", "seeds": seeds, "noise_values": d.numel(),
            "noise_mean_over_std": mean, "noise_sd_over_std": sd}
    bad = not (abs(mean + 0.5) < 0.01 and abs(sd - 1) < 0.01)
    for name, ratio in (("jitter", jit.application_ratio),
                        ("elastic", ed.application_ratio)):
        n = len(touched[name])
        rate = sum(touched[name]) / n
        line[f"{name}_scene_rate"] = rate
        line[f"{name}_ratio"] = ratio
        bad |= abs(rate - ratio) > 4 * (ratio * (1 - ratio) / n) ** 0.5
    if bad:
        raise PhaseError(f"device augmentation off its distribution: {line}")
    return line


def record_train_step(train) -> TrainRecorder:
    """One more step of the training path with every K3 and K4 call
    recorded."""
    from nerf_downstream_tpu_torch import train3d

    task, state, batch = train
    with TrainRecorder() as rec:
        train3d.train_step(task, state, batch)
    if (len(rec.k3), len(rec.k4)) != (K3_PER_STEP, K4_PER_STEP):
        raise PhaseError(f"recorded {len(rec.k3)} K3 and {len(rec.k4)} K4 "
                         "calls")
    return rec


def phase_k3(rec) -> tuple[dict, dict]:
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        window_bwd,
        window_bwd_plain,
        window_dw,
    )

    shapes: dict = {}
    err = {"d_feats_f32": 0.0, "d_feats_bf16": 0.0, "d_w_f32": 0.0,
           "d_w_bf16": 0.0, "d_w_vs_k4": 0.0}
    worst_rel = 0.0
    deterministic = True
    kernel_ms = plain_ms = bound_ms = by_bytes = 0.0
    for c3 in rec.k3:
        args = [c3[k] for k in ("g_out", "feats", "inv_starts", "inv_idx",
                                "w_t")]
        dt = args[0].dtype
        a32 = [a.float() if a.is_floating_point() else a for a in args]
        want_f, want_w = window_bwd_plain(*a32)
        checks = []
        for name, inputs in (("f32", a32), ("bf16", args)):
            got_f, got_w = window_bwd(*inputs)
            bad_f = dfeats_bad(got_f, want_f, inputs[0].dtype)
            rel, abs_w = dw_err(got_w, want_w)
            err[f"d_feats_{name}"] = max(err[f"d_feats_{name}"], float(
                (got_f.float() - want_f).abs().max()))
            err[f"d_w_{name}"] = max(err[f"d_w_{name}"], abs_w)
            worst_rel = max(worst_rel, rel)
            checks.append((name, bad_f, rel))
            if name == "bf16":
                again_f, again_w = window_bwd(*inputs)
                deterministic &= bool(torch.equal(again_w, got_w)
                                      and torch.equal(again_f, got_f))
                # the same d_w by K4 over the forward plan
                k4_w = window_dw(inputs[1], c3["starts"], c3["idx"],
                                 inputs[0])
                rel4, abs4 = dw_err(got_w, k4_w)
                err["d_w_vs_k4"] = max(err["d_w_vs_k4"], abs4)
                checks.append(("vs_k4", 0, rel4))
        g, nt, m, tile = c3["inv_idx"].shape
        c, cout = c3["feats"].shape[1], c3["g_out"].shape[1]
        key = (c, cout, g, m, tile, c3["g_out"].shape[0])
        t_k = device_ms(lambda: window_bwd(*args))
        t_p = device_ms(lambda: window_bwd_plain(*args), reps=2)
        b, by = bound(*k3_work(c3), dt)
        kernel_ms, plain_ms, bound_ms = (kernel_ms + t_k, plain_ms + t_p,
                                         bound_ms + b)
        by_bytes += b if by == "bytes" else 0.0
        s = shapes.setdefault(str(key), {
            "C": c, "Cout": cout, "G": g, "M": m, "tile": tile,
            "n_in": nt * tile, "n_out": c3["g_out"].shape[0], "calls": 0,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": by,
            "present": 0})
        s["calls"] += 1
        s["ms"] += t_k
        s["plain_ms"] += t_p
        s["bound_ms"] += b
        s["present"] += present_entries(c3["inv_starts"], c3["inv_idx"],
                                        c3["g_out"].shape[0])
        for name, bad, rel in checks:
            if bad or not rel <= DW_TOL:
                raise PhaseError(f"K3 ({name}) outside tolerance at {s}: "
                                 f"{bad} d_feats elements, d_w {rel:.3g} of "
                                 "its largest")
    line = {"phase": "k3", "calls": len(rec.k3),
            "shapes": list(shapes.values()), "max_abs_err": err,
            "d_w_worst_of_max": worst_rel, "deterministic": deterministic,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "tolerance": {"d_feats": DFEATS_TOL, "d_w_of_max": DW_TOL}}
    return line, {"max_abs_err": err["d_feats_f32"],
                  "max_abs_err_d_w": err["d_w_f32"],
                  "max_abs_err_bf16": err["d_feats_bf16"],
                  "d_w_vs_k4_max_abs": err["d_w_vs_k4"],
                  "deterministic": deterministic, "ms": kernel_ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": ("bytes" if by_bytes >= bound_ms / 2
                               else "operations"),
                  "calls_per_step": len(rec.k3)}


def phase_k4(rec) -> tuple[dict, dict]:
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        window_dw,
        window_dw_plain,
    )

    calls = []
    err = {"f32": 0.0, "bf16": 0.0}
    deterministic = True
    kernel_ms = plain_ms = bound_ms = 0.0
    by = "bytes"
    for args in rec.k4:
        a32 = [a.float() if a.is_floating_point() else a for a in args]
        want = window_dw_plain(*a32)
        rels = {}
        for name, inputs in (("f32", a32), ("bf16", list(args))):
            got = window_dw(*inputs)
            rels[name], abs_w = dw_err(got, want)
            err[name] = max(err[name], abs_w)
            if name == "bf16":
                deterministic &= bool(torch.equal(window_dw(*inputs), got))
        t_k = device_ms(lambda: window_dw(*args))
        t_p = device_ms(lambda: window_dw_plain(*args), reps=2)
        b, by = bound(*k4_work(*args), args[0].dtype)
        kernel_ms, plain_ms, bound_ms = (kernel_ms + t_k, plain_ms + t_p,
                                         bound_ms + b)
        feats, starts, idx, g_out = args
        calls.append({"C": feats.shape[1], "Cout": g_out.shape[1],
                      "G": idx.shape[0], "M": idx.shape[2],
                      "rows": g_out.shape[0],
                      "present": present_entries(starts, idx,
                                                 feats.shape[0]),
                      "ms": t_k, "plain_ms": t_p, "bound_ms": b,
                      "bound_by": by, "d_w_of_max": rels})
        if not max(rels.values()) <= DW_TOL:
            raise PhaseError(f"K4 outside tolerance: {calls[-1]}")
    line = {"phase": "k4", "calls": calls, "max_abs_err": err,
            "deterministic": deterministic, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "tolerance": {"d_w_of_max": DW_TOL}}
    return line, {"max_abs_err": err["f32"], "max_abs_err_bf16": err["bf16"],
                  "deterministic": deterministic, "ms": kernel_ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": by, "calls_per_step": len(rec.k4)}


def grad_gap(grads, ref) -> float:
    """Largest difference of two gradient sets, as a fraction of each
    parameter's largest reference entry."""
    return max(float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
               for g, r in zip(grads, ref))


def phase_train_model() -> dict:
    """One f32 ``train_8k`` step, kernel path against plain path.

    Whole steps: through the kernels twice, through the plain versions,
    and through the plain versions with K2's (g, m) terms summed in
    reverse order (a forward that differs from the plain one by rounding
    alone). The loss and running statistics of the kernel path are held to
    the plain path and to its own repeat. Their gradients are reported
    beside the count of ReLU gates whose side differs between the two
    forwards: a pre-activation within rounding of zero that takes the
    other side moves a weight gradient by a whole row's term, about
    1/sqrt(rows) of its largest entry, whatever the kernels do. The
    gradients and the SGD update are held on one forward graph,
    differentiated once through K3/K4 and once through their plain
    versions."""
    import contextlib

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import serve, train3d
    from nerf_downstream_tpu_torch.sparse.types import PointField

    batch = serve.to_device(
        train3d.make_batch("train_8k", np.random.default_rng(1)), "cuda")

    def build():
        return train3d.build_training("Res16UNet18A", "train_8k",
                                      device="cuda", seed=0,
                                      compute_dtype=torch.float32)

    paths = {
        "kernel": contextlib.nullcontext, "kernel_again":
        contextlib.nullcontext, "plain": PlainPath,
        "plain_reordered": lambda: PlainPath(
            window_gather_matmul=reversed_sum_gmm)}
    runs = {}
    for name, path in paths.items():
        with GateRecorder() as gates:
            task, state = build()
        with path():
            state, mets = train3d.train_step(task, state, batch)
        runs[name] = dict(
            loss=float(mets["loss"]), gates=gates.inputs,
            stats={k: v.clone() for k, v in state.model.named_buffers()},
            grads=[p.grad.clone() for p in state.model.parameters()])

    def compare(a, b) -> dict:
        ra, rb = runs[a], runs[b]
        return {
            "loss_rel_err": abs(ra["loss"] - rb["loss"]) / abs(rb["loss"]),
            "running_stat_elements_outside": sum(
                int(((ra["stats"][k] - v).abs() > 1e-5 + 1e-4 * v.abs())
                    .sum()) for k, v in rb["stats"].items()),
            "grad_gap_of_max": grad_gap(ra["grads"], rb["grads"]),
            "relu_gates_flipped": sum(
                int(((x > 0) != (y > 0)).sum())
                for x, y in zip(ra["gates"], rb["gates"])),
            "relu_input_drift_of_max": max(
                float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
                for x, y in zip(ra["gates"], rb["gates"]))}

    whole = {f"{a}_vs_{b}": compare(a, b) for a, b in (
        ("kernel", "plain"), ("kernel", "kernel_again"),
        ("plain", "plain_reordered"))}

    task, state = build()
    b = task.augment(batch, state.step)
    logits = state.model(PointField(coords=b["coordinates"],
                                    feats=b["features"], mask=b["mask"]))
    graph_loss = task.loss_and_metrics(logits, b)[0]
    names, params = zip(*state.model.named_parameters())
    grads = torch.autograd.grad(graph_loss, params, retain_graph=True)
    with PlainPath():
        ref_grads = torch.autograd.grad(graph_loss, params)
    errs = [grad_gap([g], [r]) for g, r in zip(grads, ref_grads)]

    # the SGD update of each gradient set, from the same parameters
    updated = []
    for gs in (grads, ref_grads):
        _, st = build()
        for p, g in zip(st.model.parameters(), gs):
            p.grad = g.clone()
        st.optimizer.step()
        updated.append([p.detach() for p in st.model.parameters()])
    lr = task.lr
    param_err = max(float(((a - r).abs() / (
        lr * TRAIN_GRAD_TOL * g.abs().max() + 1e-6 * (1 + r.abs()))).max())
        for a, r, g in zip(*updated, ref_grads))
    line = {"phase": "train_model", "preset": "train_8k", "dtype": "float32",
            "loss": runs["kernel"]["loss"],
            "plain_loss": runs["plain"]["loss"],
            "relu_gates": sum(x.numel() for x in runs["plain"]["gates"]),
            "whole_step": whole,
            "grad_err_of_max": max(errs),
            "worst_grad": names[int(np.argmax(errs))],
            "param_err_of_tol": param_err,
            "tolerance": {"loss": TRAIN_LOSS_TOL, "grad": TRAIN_GRAD_TOL,
                          "param": "lr x grad tolerance + 1e-6 (1 + |p|)",
                          "running": [1e-4, 1e-5]}}
    held = [whole["kernel_vs_plain"], whole["kernel_vs_kernel_again"]]
    ok = (np.isfinite(line["loss"]) and max(errs) <= TRAIN_GRAD_TOL
          and param_err <= 1
          and all(h["loss_rel_err"] <= TRAIN_LOSS_TOL
                  and h["running_stat_elements_outside"] == 0 for h in held))
    if not ok:
        raise PhaseError(f"training step, kernel vs plain path: {line}")
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
        phase = "train"
        line, train_launches, train = phase_train(card, torch.bfloat16)
        emit(line)
        phase = "augment"
        emit(phase_augment())
        phase = "record_train"
        rec = record_train_step(train)
        del train
        phase = "k3"
        line, k3 = phase_k3(rec)
        emit(line)
        phase = "k4"
        line, k4 = phase_k4(rec)
        emit(line)
        del rec
        phase = "train_model"
        emit(phase_train_model())
    except Exception as e:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        raise
    def paths(name):
        return {"launches": launches[name] + train_launches[name],
                "launches_by_path": {"serve": launches[name],
                                     "train": train_launches[name]}}

    src = "nerf_downstream_tpu_torch/ops/kernels/"
    tpu = "nerf_downstream_tpu/ops/pallas/window_gather.py"
    # why library_ms is null: no single PyTorch call computes these
    no_library = {
        "window_match": "searchsorted ranks in the whole table, not the "
                        "in-window rank or -1",
        "window_gather_matmul": "a per-offset gather and product summed "
                                "over the offsets of a plan",
        "window_bwd": "a gather-matmul over the inverse plan plus a "
                      "per-offset gathered outer-product sum",
        "window_dw": "a per-offset gathered outer-product sum",
    }
    kernels = [
        dict(name="window_match", route="cuda",
             source=src + "window_match.cu", replaces=f"{tpu}:387",
             bound_by="bytes", library_ms=None,
             shapes="one eval_64k forward (bf16)",
             **paths("window_match"), **k1),
        dict(name="window_gather_matmul", route="cuda",
             source=src + "window_gather_matmul.cu", replaces=f"{tpu}:131",
             library_ms=None, shapes="one eval_64k forward (bf16)",
             **paths("window_gather_matmul"), **k2),
        dict(name="window_bwd", route="cuda", source=src + "window_bwd.cu",
             replaces=f"{tpu}:504", library_ms=None,
             shapes="one train_64k step (bf16)", **paths("window_bwd"),
             **k3),
        dict(name="window_dw", route="cuda", source=src + "window_dw.cu",
             replaces=f"{tpu}:590", library_ms=None,
             shapes="one train_64k step (bf16)", **paths("window_dw"), **k4),
    ]
    for k in kernels:
        k["library_ms_null_because"] = no_library[k["name"]]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
