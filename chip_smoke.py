#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card at full width:
Res16UNet18A sparse-voxel serving (``nerf_downstream_tpu_torch.serve``),
the PAConv trainer (PAConvDGCNN and the other dense point models), one
training step of ResUNetBN2C and EncodedRes16UNet,
its training step (``nerf_downstream_tpu_torch.train3d``), the training
CLI on the flagship segmentation configs, on the README's
classification command (``nerf_downstream_tpu_torch.co3d_3d.train``,
ResNet14 with auto-calibration, then AdamW, tensorboard, process workers
and a self-supervised transfer) and on ModelNet40 (MinkowskiFCNN, every
conv on the row path), the fused 2D+3D ensemble through the task API
with each of the nine optimizers, the 2D classification CLI
(``nerf_downstream_tpu_torch.co3d_2d.train``, ResNet50 and ViT-B/16; no
TPU kernel lies on that path: cuDNN and cuBLAS stand where XLA's ops
stood) and the evaluation of pruned checkpoints
(``nerf_downstream_tpu_torch.eval3d``),
with the hand-written CUDA kernels K1 ``window_match``, K2
``window_gather_matmul`` (forward), K3 ``window_bwd`` and K4
``window_dw`` (backward), K5 ``window_gather_matmul_bs`` (block-sparse
forward) and K6 ``row_gather_matmul`` (row gather-matmul), and holds
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
   forward: in f32 (CUDA cores) within atol = rtol = 1e-5; in bf16
   (tensor cores) against the plain version in f32 within rtol = 2^-8,
   atol = 1e-5 (one rounding of the f32 sum into bf16 is at most 2^-9
   relative; the rest covers the order of f32 sums); the C = 27 stem conv
   against the same call with Cin zero-padded to 32 (must be identical);
   two bf16 launches bit-identical. Per shape: the core with its column
   tile and term split, the roofline share (bound / time), and for
   information the time of an im2col (``index_select``) plus one
   ``torch.matmul`` on the same inputs (``composite_ms``; the port never
   calls it);
6. model: whole-model logits of the kernel path against the plain path,
   both f32 on the card, ``serving_8k``, within 1e-4 relative to the
   largest logit;
6b. row_route: Res16UNet14A at ``serving_8k`` in f32 with seeded weights
   on its windowed path and, with the same weights, with every conv on
   the row path (method "row" with the grid index, and "search"): the
   row path's logits within 1e-4 x max|logit| of the windowed path's; K6
   launched, no windowed kernel, launch counts reset just before the row
   forwards and read just after;
6c. models_extra: the rest of the 3D registry, one f32 training step
   each on row_route's ``serving_8k`` batch at full width with seeded
   weights: ResUNetBN2C with every conv on the row path (K6) and
   EncodedRes16UNet on the preset's windowed knobs (K1, the pass, K2-K4),
   launch counts reset before each step and read after; every K6 call
   (``k6_calls``) and every K1-K4 call (``cli_kernels_f32``) of the steps
   held against its plain version and timed beside its bound; then the
   eval-mode and the train-mode output before the step, each within
   1e-4 x max of the CPU's (on a miss, the first module that leaves
   the CPU's is named);
7. train: ``train_64k`` (8 scenes, 64k rows, device augmentation, bf16)
   for 5 SGD steps through ``train3d``, launch counts reset just before
   and read just after (41 K3 and 1 K4 launches per step); every loss
   finite and all distinct; then a profile of 2 more steps; and the
   device augmentation against its distribution (per-scene gate rates of
   the jitter and the elastic warp, the jitter's noise moments);
8. k3 / k4: every K3 and K4 call of one more recorded step against the
   plain versions, in f32 and in bf16 (both on the tensor cores in bf16:
   every recorded call must have bf16 inputs). d_feats: as K2 (rtol 1e-5
   in f32, 2^-8 in bf16 against the f32 plain version), with the absolute
   term scaled by the largest value (gradients of a mean loss over 62,400
   points are small). d_w is an f32 sum over up to 65,536 rows whose
   plain version takes the same inputs (bf16 ones cast up exactly), so
   only the order and fusing of the f32 sums differs: within 1e-5 x
   max|d_w| of each (g, m).
   K3's d_w against K4's over the forward plan within the same bound;
   two launches on the same inputs bit-identical. Per K3 shape: the
   cores, d_feats' column tile and term split, d_w's tiles, the roofline
   share, and the d_feats half timed alone (K2's wrapper on the inverse
   plan); per K4 call: the core, its tiles and row chunks, and the
   roofline share;
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
   ``phase_train_model``); and the ops PyTorch names as nondeterministic
   over one kernel-path step under
   ``torch.use_deterministic_algorithms(True, warn_only=True)``. Every
   accumulating scatter of the step adds in a fixed order, so the two
   kernel-path steps (in PyTorch's default mode) must give bit-identical
   losses, gradients, updated weights and running statistics;
9b. cli_train: the training CLI as a user runs it, on the two flagship
   configs unchanged (full width, batch 8, SGD with momentum 0.9, cosine
   lr, the host transforms and the device jitter and elastic warp, f32
   as the configs bind no compute type) over a synthetic
   PeRFception-ScanNet tree the port writes (``CLI_TREE``: batches of
   50,000-65,536 valid finest rows): 6 steps validating every 3 and
   testing the best checkpoint, then ``--resume`` to 8, launch counts
   reset before and read after; finite losses, the checkpoints, the
   result and metric files, the resumed run starting at step 6 from the
   checkpoint's momentum buffers bit for bit, and every conv in f32.
   Reports wall ms per step, host ms per batch, ms per validation pass,
   then for one more step its synchronising calls, device time and ops
   (profile), and each K1-K4 call held against its plain version and
   timed, with its bound (f32, CUDA cores);
9b'. cli_methods: the same CLI from cli_train's best checkpoint on its
   tree and seed, 3 steps on the default route ("auto", fully windowed)
   and 3 under each of "window" (plans from row kernel maps: K2/K3 for
   the stride-preserving convs, K6 for the strided ones and the
   transposes), "block" (each k3/s1 conv through dense 4^3 blocks, cuDNN
   without TF32; K6 elsewhere) and "block_resident" (every level in dense
   blocks; no custom kernel), with ``METHOD_BINDINGS`` (the window size
   and per-level block caps CLI_TREE needs), launch counts reset before
   each run
   and read after: each method's step-1 loss within 1e-4 (relative) of
   "auto"'s, the start weights' eval logits within 1e-4 x max|logit| of
   "auto"'s, two runs of a step bit-identical, its route taken; per
   method wall ms per step, device ms, busy share and device ops of one
   profiled step, launches; under "window" every K2/K3 call of a step,
   and under "window" and "block" every K6 call, against its plain
   version;
9b''. cli_kitti: the same CLI on ``scannet_plenoxel.gin`` turned to
   SemanticKITTI (``KITTI_BINDINGS``: the KITTI reader, xyzi in, 19
   classes, batch 2, "hybrid" without a grid extent) over scans the port
   writes in the benchmark's layout (HDL-64E size: 64 beams x 2,048
   azimuths, ground, building fronts and boxes to 80 m, raw labels with
   moving classes): 3 steps and a validation on sequence 08, launch
   counts reset before and read after; finite losses, two runs of a step
   bit-identical, every K1-K4 call of a step against its plain version,
   one 08 scan's eval logits on the card within 1e-4 x max|logit| of the
   CPU's on the row path, and its ``save_prediction`` file (uint32 raw
   ids, one per point);
9c. cli_cls: the README's classification command (``co3d_cls.gin`` +
   ``co3d_aug3.gin`` + ``feature_sh.gin`` + ``resnet14.gin``: ResNet14
   at full width, 51 classes, batch 16, val batch 8, f32) over a
   synthetic PeRFception-CO3D tree the port writes (``CLS_TREE``: 32
   train and 8 val shells of 10,000 voxels at 128^3): the CLI
   auto-calibrates its capacity knobs on the card (timed), 6 steps with
   one validation pass, then ``--resume`` to 8 with those knobs pinned,
   launch counts reset before and read after; finite losses, ``val/acc1``
   logged, the checkpoints and logs, the resume bit-equal in the momentum
   buffers, every conv in f32, K1, the pass, K2, K3 and K6 launched.
   Then for one more step: its synchronising calls, a profile, its K1-K3
   calls against their plain versions in f32, every K6 call (the four
   k3/s2 convs on the row path) and every K2 and K3 call at 512 channels
   against their plain versions in f32 and, at the same shapes, in bf16
   (rtol 1e-5 and 2^-8 of the f32 sum), each timed beside its bound;
9c*. ensemble: the fused 2D+3D classifier through the task API
   (``Ensemble2D3D(out_channel=51, "resnet18", "ResNet14")``,
   ``EnsembleClassificationTraining``) at full width, batch 16 of 224 x
   224 frames (one synthetic frame per cli_cls scene) and cli_cls's
   scenes, knobs and capacity, f32 (TF32 off, deterministic cuDNN), SGD
   with ``co3d_cls.gin``'s momentum, lr and weight decay: 5 steps with
   "logit" fusion and 2 with "feature", launch counts reset before and
   read after; finite losses, both branches moved, two runs of a step
   bit-identical, a saved and restored state's next step bit-equal, the
   eval logits on the card within 1e-4 x max|logit| of the CPU's, every
   K1, pass, K2, K3 and K6 call of a step against its plain version;
   median ms, a profiled step (device ms, busy share, ops, the port's
   kernels' device ms) and the 2D branch's forward and backward device
   ms;
9c**. optimizers: each of the nine optimizers of ``train/optim.py`` for 3
   steps from the ensemble's state: finite losses, the card's last
   update within 1e-5 x max|update| of the CPU's step on the same state
   and gradients, a training state saved in the optax layout and
   restored giving a bit-equal next step; ms per optimizer step;
9c***. cli_surface: the training CLI on cli_cls's configs, tree, knobs
   and capacity with AdamW, the csv and tensorboard loggers, process
   workers and cli_cls's best checkpoint through
   ``transfer_self_supervised``: 3 steps, then ``--resume`` to 4; finite
   losses, the first step's weights the checkpoint's but the ``final``
   leaves, the resume starting from the checkpoint's weights and AdamW
   state bit for bit, the first two batches those of thread workers, no
   worker process left; which logger path ran and the host ms per batch
   of process and thread workers;
9c'. cli_modelnet: ``modelnet40_cls.gin`` through the training CLI at
   full width (MinkowskiFCNN, channels 32-128, embedding 1024, batch 32
   of 2,048-point clouds, val batch 16, f32) on 64 train and 16 test
   synthetic clouds in the unit sphere (``MN_CLOUDS``; HDF5 files where
   h5py is installed, else the same clouds through the reader's
   ``arrays`` constructor), 6 steps with one validation pass, then
   ``--resume`` to 8, launch counts reset before and read after: finite
   losses, ``val/acc1`` logged, the resume bit-equal in the momentum
   buffers, every conv in f32 on the row path, K6 launched and no
   windowed kernel; then two runs of one step bit-identical, one more
   step profiled with its synchronising calls counted, every K6 call of a
   recorded step against its plain version in f32 (``k6_bad``) timed
   beside its bound, and MinkowskiFCNN's and MinkowskiSplatFCNN's eval
   logits on the card within 1e-4 x max|logit| of the CPU's;
9c''. cli_paconv: the PAConv trainer
   (``nerf_downstream_tpu_torch.co3d_3d.paconv_train``) at its defaults
   and full width (1,024 points, k 20, batch 32, SGD lr 0.1, cosine, f32)
   on 192 + 32 synthetic clouds: PAConvDGCNN for 6 steps and one
   validation, ``--resume`` to 8 (momentum bit-equal), PAConvPointNet,
   DGCNN_cls and PointNet for 2 steps each; no custom kernel lies on this
   path (every launch count stays 0); finite losses, ``val/acc1`` logged,
   two runs of a step bit-identical, each model's eval logits on the card
   within 1e-4 x max|logit| of the CPU's with the kNN lists compared; ms
   per step, one more step's synchronising calls, device time, busy
   share, device ops, peak memory and assign-score's share of the step;
9d. model_2d: ResNet50 and ViT-B/16 at 224 x 224, batch 32, seeded
   weights with every norm drawn away from identity, eval mode: f32 on
   the card (TF32 off) against f32 on the CPU within 1e-4 x max|logit|,
   bf16 against f32 on the card within 5e-2 x max|logit|; top-1
   agreement, the gaps and each forward's device time;
9e. cli_2d and cli_2d_vit: the 2D CLI on
   ``co3d_2d/configs/ours_scratch_bkgd/resnet50.gin`` and
   ``ours_scratch/vitbase.gin`` unchanged at full width (batch 32 of 224
   crops, bf16, SGD lr 0.1 with warmup, AugMix, 8 loader workers; the
   ResNet's with background swaps at 0.5) on a synthetic frame tree the
   port writes (``FRAMES_2D``), only data paths, file lists,
   ``frames_per_scene``, ``max_epochs``, ``check_val_every_n_epoch`` and
   the log directory bound: 6 (ViT: 4) steps with one validation pass and
   the test phase, then a resume from ``last.ckpt`` for 2 steps, whose
   first step must start from the checkpoint's weights and momentum bit
   for bit and give, bit for bit, the loss the first run's final state
   gives on that batch; finite losses, ``val/acc`` logged, the
   checkpoints, bf16 compute, no custom kernel launched. Reports the
   step's wall median, host ms per batch (one worker; waited with 8), ms
   per validation pass, and for one more step its synchronising calls,
   device time, busy share, device ops and device time by kind of kernel
   (``kernel_share``);
10. sparse_eval: ``eval3d`` at ``eval_64k`` (bf16, 3 batches) over
    checkpoints this phase writes with the port's ``save_checkpoint`` from
    seeded weights: dense; ZAXIS (``--sparsify``, mode 2); mode 1 with
    ``--layout strided`` over a negation-closed offset pruning; mode 1
    with ``--layout csr`` over half the weight blocks pruned at
    granularity 128 and at 32. Launch counts are reset just before and
    read just after each ``eval3d`` run; per configuration: 20 request
    times after a warm-up (median, quartiles, range), device time, busy
    share and device ops from a profile, host wall time in 10 turns of
    (dense, config, config, dense) over 3 requests with the paired gap's
    median and range (resolved only where the range excludes zero), the
    synchronising calls of one request as in phase 3, the
    convs on each route (windowed, block-sparse, row), and the f32 logits
    against the dense model on the same zeroed weights within
    1e-4 x max|logit| (the bf16 gap is reported); then the capacity
    guard: the request of seed 0 whose first down conv overflows its
    window coverage (in the reference too) must come out all NaN;
11. k5: every K5 call of one recorded forward at granularity 128 and at
    32 (each with bf16 inputs, so on the tensor cores) against its plain
    version (rtol 1e-5 in f32, 2^-8 in bf16 against the f32 sum) and
    against K2 on the spec-masked weights: K5 runs K2's core (tensor
    cores in bf16, CUDA cores in f32) with K2's column tile and term
    split and only skips steps that add exact zeros, so in both types it
    must equal K2's output bit for bit; two launches bit-identical. Per
    shape: the core, column tile and split, the share of the (term,
    32-channel chunk, column tile) steps the spec keeps, K5 and K2 ms and
    the roofline share. K5 against K2 on the same plans at 10, 25, 50 and
    75 % dead blocks (the dead-block crossover). K5 is timed as one
    launch on weights already zero on every dead block (the block tier
    keeps them so; ``masked=True``), as K2 is on the same weights;
12. k6: every K6 call of one recorded ZAXIS forward and one offset-pruned
    forward (each with bf16 inputs, so on the tensor cores) against its
    plain version (rtol 1e-5 of the f32 sum, in f32 and in bf16 inputs,
    f32 output), two launches bit-identical; per call the core, column
    tile and step split, and for information an im2col plus one
    ``torch.matmul``; the ptxas lines of K2, K3, K5 and K6, per kernel;
13. the ``kernels`` line, the card line, and the ``ok`` line.

On the bf16 main paths (``serve``, ``train``, ``sparse_eval``) every
K2, K3, K4, K5 and K6 launch must run on the tensor cores; ``cli_train``,
``cli_cls``, ``cli_modelnet``, ``cli_semseg`` and ``row_route`` compute in
f32 by their configurations, and their lines say so. Phase
``cli_semseg`` also holds each K4 call of one step against its plain
version and times it beside its bound (``k4_step``), and each K3 call
of that step with its d_w half timed alone (``k3_dw_step``). The input
type is the only switch (``tc.gather_choice``, ``tc.dw_choice``,
``tc.row_choice``) and every conv casts its inputs to its compute type, so
each phase fails unless every conv of its model computes in bf16, and
reports its K2-K6 launch counts under that core; phases ``k2``-``k6`` fail
unless every recorded call of their kernel on a main path has bf16
inputs.

Every phase prints one JSON line; any failure exits non-zero without the
``ok`` line. Without a GPU, or without the package beside this file, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
SPARSE_BATCHES = 3  # eval3d's requests per configuration (the path run)
SPARSE_REQUESTS = 20  # timed requests per configuration, after one warm-up
WALL_TURNS = 10  # (dense, config, config, dense) turns per pruned config
# the fifth eval_64k batch of seed 0 overflows the first down conv's
# window coverage, in the reference too (tests/test_torch_port_eval_caps.py)
OVERFLOWING_REQUEST = 4
SPARSE_TOL = 1e-4  # of max|logit|, sparse config vs dense on zeroed weights
K5_DEAD_SHARES = (0.10, 0.25, 0.50, 0.75)
ONES, TWOS = ",".join("1" * 9), ",".join("2" * 9)
# pruned-eval configurations: (pruning of the checkpoint, eval3d flags)
SPARSE_CONFIGS = {
    "dense": (None, []),
    "zaxis": ("zaxis", ["--sparsify", "--sparse_mode", TWOS]),
    "offsets_strided": ("offsets", ["--sparsify", "--sparse_mode", ONES,
                                    "--layout", "strided"]),
    "blocks128_csr": (128, ["--sparsify", "--sparse_mode", ONES, "--layout",
                            "csr", "--block_live_granularity", "128"]),
    "blocks32_csr": (32, ["--sparsify", "--sparse_mode", ONES, "--layout",
                          "csr", "--block_live_granularity", "32"]),
}
# symmetric (negation-closed) live offsets with (dx, dy) groups of one
# size, so the escape lists stay on; 4 of the 8 offsets of a down conv
UNIFORM_OFFSETS = (0, 4, 8, 9, 13, 17, 18, 22, 26)
DOWN_OFFSETS = (0, 3, 4, 7)
# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# FLOP/s of the bf16 tensor cores and of f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


WINDOW_KERNELS = ("window_starts", "window_match", "window_gather_matmul")
# the files of the plan and conv path, which may not synchronise the host
# with the card during a request or step
NO_SYNC_FILES = ("nerf_downstream_tpu_torch/ops/window_conv.py",
                 "nerf_downstream_tpu_torch/sparse/kernels.py",
                 "nerf_downstream_tpu_torch/models/mink/layers.py")
# the plans whose arrays phase k1 holds against the plain versions' plans
PLAN_ARRAYS = ("starts", "idx", "n_escaped", "esc_k", "esc_i", "esc_j",
               "esc_stats")
TRAIN_KERNELS = WINDOW_KERNELS + ("window_bwd", "window_dw")
# the kernels whose bf16 calls run on the tensor cores
TENSOR_CORE_KERNELS = ("window_gather_matmul", "window_bwd", "window_dw",
                       "window_gather_matmul_bs", "row_gather_matmul")


class PhaseError(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def sync_count(where: str, fn) -> dict:
    """Synchronising calls of ``fn()`` on the card (the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``), by file and line; raises
    when one comes from ``NO_SYNC_FILES``."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = collections.Counter()
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        path = os.path.relpath(w.filename, REPO)
        sites[f"{path}:{w.lineno}"] += 1
    ours = {k: v for k, v in sites.items()
            if k.split(":")[0] in NO_SYNC_FILES}
    out = {"synchronising_calls": sum(sites.values()),
           "from_plan_and_conv_files": sum(ours.values()),
           "sites": dict(sites.most_common())}
    if ours:
        raise PhaseError(f"{where}: synchronising calls from the plan and "
                         f"conv path: {ours}")
    return out


def tensor_core_check(where: str, model, counts: dict) -> dict:
    """The launches in ``counts`` of K2-K5 by core. The input type picks
    the core and every conv casts its inputs to its compute type: raises
    unless every conv of ``model`` computes in bf16 (the tensor cores)."""
    import torch

    from nerf_downstream_tpu_torch.models.mink.layers import (
        SparseConv,
        SparseConvTranspose,
    )
    from nerf_downstream_tpu_torch.ops.kernels import tc

    types = {m.compute_dtype for m in model.modules()
             if isinstance(m, (SparseConv, SparseConvTranspose))}
    if types != {torch.bfloat16}:
        raise PhaseError(f"{where}: convs compute in {types}, want bf16")
    return {tc.TENSOR_CORES: {k: counts[k] for k in TENSOR_CORE_KERNELS}}


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


def _cloned(args):
    return tuple(a.clone() if hasattr(a, "clone") else a for a in args)


class PlanRecorder:
    """Records the inputs of every plan built (``build_plan_direct``), of
    every window-starts pass and of every K1 call inside it, by wrapping
    the names the package's modules call. Calls go on to the real
    functions."""

    def __init__(self):
        self.plans: list[tuple] = []
        self.starts: list[tuple] = []
        self.k1: list[tuple] = []

    def __enter__(self):
        from nerf_downstream_tpu_torch.ops import window_conv

        self._plan_saved = (window_conv.build_plan_direct,
                            window_conv.window_starts,
                            window_conv.window_match)
        build, starts, match = self._plan_saved

        def rec_build(*args, **kwargs):
            self.plans.append((_cloned(args), dict(zip(
                kwargs, _cloned(kwargs.values())))))
            return build(*args, **kwargs)

        def rec_starts(*args):
            self.starts.append(_cloned(args))
            return starts(*args)

        def rec_match(*args):
            self.k1.append(_cloned(args))
            return match(*args)

        window_conv.build_plan_direct = rec_build
        window_conv.window_starts = rec_starts
        window_conv.window_match = rec_match
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.ops import window_conv

        (window_conv.build_plan_direct, window_conv.window_starts,
         window_conv.window_match) = self._plan_saved
        return False


class Recorder(PlanRecorder):
    """Records what ``PlanRecorder`` records, and the inputs of every K2
    call of a forward (and the window blocks of each windowed conv's
    plan), by wrapping the names the package's modules call. Calls go on
    to the real wrappers."""

    def __init__(self):
        super().__init__()
        self.k2: list[tuple] = []
        self.blocks: list[int] = []

    def __enter__(self):
        from nerf_downstream_tpu_torch.models.mink import layers
        from nerf_downstream_tpu_torch.ops import window_conv

        super().__enter__()
        self._saved = (window_conv.window_gather_matmul,
                       layers.window_conv_apply)
        gmm, apply = self._saved

        def rec_gmm(feats, starts, idx, w):
            self.k2.append((feats.clone(), starts.clone(), idx.clone(),
                            w.clone()))
            return gmm(feats, starts, idx, w)

        def rec_apply(feats, plan, *args, **kwargs):
            self.blocks.append(plan.blocks)
            return apply(feats, plan, *args, **kwargs)

        window_conv.window_gather_matmul = rec_gmm
        layers.window_conv_apply = rec_apply
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.models.mink import layers
        from nerf_downstream_tpu_torch.ops import window_conv

        window_conv.window_gather_matmul, layers.window_conv_apply = (
            self._saved)
        super().__exit__(*exc)
        return False


class PlainPath:
    """Routes the model's kernel calls to the plain PyTorch versions (the
    reference side of the whole-model comparison on the card), or to the
    functions ``override`` names."""

    NAMES = ("window_starts", "window_match", "window_gather_matmul",
             "window_bwd", "window_dw")

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


class TrainRecorder(PlanRecorder):
    """Records what ``PlanRecorder`` records, and the inputs of every K3
    and K4 call of a training step, with the forward plan of each K3 call
    (kept by a subclass of the conv's autograd Function that the recorder
    puts in its place). Calls go on to the real kernels."""

    def __init__(self):
        super().__init__()
        self.k3: list[dict] = []
        self.k4: list[tuple] = []

    def __enter__(self):
        from nerf_downstream_tpu_torch.ops import window_conv as wc

        super().__enter__()
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
        super().__exit__(*exc)
        return False


def k1_bytes(args) -> int:
    """Bytes K1 must move: the key table and the query keys and mask read
    once, starts read once, idx written once (the deltas are parameters)."""
    hi, lo, o_hi, o_lo, out_mask, deltas, starts = args[:7]
    tile = args[7]
    g, nt = starts.shape
    m = len(deltas[0])
    return int(8 * hi.numel() + 9 * o_hi.numel() + 4 * starts.numel()
               + 4 * g * nt * m * tile)


def starts_bytes(args) -> int:
    """Bytes the window-starts pass must move: the key table read once,
    the query key of each tile's first row read once, starts and emax
    written once, the counts written once."""
    hi, o_hi, deltas, tile = args[0], args[2], args[6], args[7]
    g, nt = len(deltas), o_hi.shape[0] // tile
    return int(8 * hi.numel() + 8 * nt + 8 * g * nt + 4 * (g + 1) + 8)


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


def k6_bad(x_ext, km, w, got, want) -> int:
    """Elements of a K6 result (``got``) farther from the f32 plain sum
    (``want``) than ``K2_F32_TOL`` x (1 + the sum of the absolute
    products): an f32 sum's rounding grows with the size of its terms,
    not with what is left where they cancel."""
    from nerf_downstream_tpu_torch.ops.kernels import row_gather_matmul_plain

    scale = row_gather_matmul_plain(x_ext.float().abs(), km, w.float().abs())
    return int(((got - want).abs() > K2_F32_TOL * (1 + scale)).sum())


def dw_err(got, want) -> tuple[float, float]:
    """(largest |got - want| / max|want| over the (g, m) slices, largest
    |got - want|)."""
    d = (got - want).abs().flatten(2).amax(-1)
    scale = want.abs().flatten(2).amax(-1).clamp(min=1e-30)
    return float((d / scale).max()), float(d.max())


def ptxas_by_kernel(log: str) -> dict:
    """nvcc's ptxas report of one source as {entry function: its register,
    shared-memory and spill lines}."""
    out: dict = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out.setdefault(name, [])  # a name nvcc reports twice keeps both
        elif name is not None and ("registers" in ln or "spill" in ln):
            out[name].append(ln.strip().replace("ptxas info    : ", ""))
    return out


def phase_build() -> dict:
    from nerf_downstream_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    for stem in libs:
        build.library(stem)
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "libraries": sorted(os.path.basename(p) for p in libs.values()),
            "ptxas": {k: ptxas_by_kernel(v)
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
        cores = tensor_core_check(preset, model, counts)
        for name in WINDOW_KERNELS:
            if counts[name] <= 0:
                raise PhaseError(f"{preset}: kernel {name} never launched")
        for name, c in counts.items():
            launches[name] += c
        out["presets"][preset] = {
            "requests": n, "valid_rows": rows, "ms": times,
            "ms_median_after_first": float(np.median(times[1:])),
            "launches": counts, "launches_by_core": cores,
            "launches_per_request": {k: v / n for k, v in counts.items()},
            "sync": sync_count(preset, lambda: serve.eval_step(model,
                                                              batches[0])),
        }
    return out, launches


def profile_requests(model, batches) -> dict:
    """Where a request's time goes: host wall time against the device time
    of every kernel (torch.profiler, CUPTI), per request, after warmup."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_downstream_tpu_torch import serve

    n = len(batches)
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
    return {"requests": n, "wall_ms_per_request": wall,
            "wall_ms_per_request_profiled": wall_profiled,
            "device_ms_per_request": device,
            "device_busy_share": device / wall,
            "device_ops_per_request": sum(r[1] for r in rows),
            "top_device": [{"name": k[:90], "per_request": c, "ms": ms}
                           for ms, c, k in rows[:12]]}


def phase_profile(preset: str, n: int, dtype) -> dict:
    """``profile_requests`` of ``n`` requests of ``preset``."""
    import numpy as np

    from nerf_downstream_tpu_torch import serve

    model = serve.build_segmenter("Res16UNet18A", ctx_preset=preset,
                                  device="cuda", seed=0, compute_dtype=dtype)
    rng = np.random.default_rng(2)
    batches = [serve.to_device(serve.make_batch(preset, rng), "cuda")
               for _ in range(n)]
    return {"phase": "profile", "preset": preset, "dtype": str(dtype),
            **profile_requests(model, batches)}


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


def plan_mismatches(a, b) -> dict:
    """Elements that differ per array of two window plans."""
    import torch

    out = {}
    for name in PLAN_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None):
            out[name] = "present in one plan only"
        elif x is not None:
            out[name] = (int((x != y).sum()) if x.shape == y.shape
                         else f"shapes {tuple(x.shape)}, {tuple(y.shape)}")
    if (a.perm, a.tile, a.window, a.blocks) != (b.perm, b.tile, b.window,
                                                b.blocks):
        out["layout"] = "differs"
    return {k: v for k, v in out.items() if v}


def phase_k1(recs: dict) -> tuple[dict, dict, dict]:
    """K1 and the window-starts pass. Every plan that one forward of
    ``serving_8k`` and of ``eval_64k`` and one ``train_64k`` step built on
    the card is built again on the card by the kernels and by the plain
    versions: the two must be equal element for element (starts, idx,
    n_escaped, the escape lists and their statistics), every pass's
    starts, emax and n_escaped must equal its plain version's, and every
    K1 call its plain version's. Each pass and K1 call of the eval_64k
    forward is timed beside its plain version and its bytes bound."""
    import torch

    from nerf_downstream_tpu_torch.ops import window_conv
    from nerf_downstream_tpu_torch.ops.kernels import (
        match,
        window_match,
        window_match_plain,
        window_starts,
        window_starts_plain,
    )

    checked = {}
    for path, rec in recs.items():
        n_plans = len(rec.plans)
        if not (n_plans == len(rec.starts) == len(rec.k1) > 0):
            raise PhaseError(f"{path}: {n_plans} plans, {len(rec.starts)} "
                             f"passes, {len(rec.k1)} K1 calls recorded")
        for args, kwargs in rec.plans:
            got = window_conv.build_plan_direct(*args, **kwargs)
            with PlainPath():
                want = window_conv.build_plan_direct(*args, **kwargs)
            bad = plan_mismatches(got, want)
            if bad:
                raise PhaseError(f"{path}: a plan built by the kernels "
                                 f"differs from the plain versions' plan: "
                                 f"{bad}")
        for args in rec.starts:
            for name, x, y in zip(("starts", "emax", "n_escaped"),
                                  window_starts(*args),
                                  window_starts_plain(*args)):
                if not torch.equal(x, y):
                    raise PhaseError(f"{path}: the pass's {name} differs "
                                     "from its plain version")
        for args in rec.k1:
            if not torch.equal(window_match(*args), window_match_plain(*args)):
                raise PhaseError(f"{path}: K1 differs from its plain version")
        checked[path] = {"plans": n_plans, "escape_lists": sum(
            kw.get("escape_cap", 0) > 0 for _, kw in rec.plans)}

    rec = recs["eval_64k"]
    plans = []
    tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "starts_ms",
                         "starts_plain_ms", "starts_bound_ms"), 0.0)
    for s_args, args in zip(rec.starts, rec.k1):
        hi, _, o_hi, _, _, deltas, starts, tile, window, blocks = args
        kind = ("same-set" if o_hi.shape == hi.shape
                and bool((o_hi == hi).all()) else "cross")
        t_s = device_ms(lambda: window_starts(*s_args))
        t_sp = device_ms(lambda: window_starts_plain(*s_args), reps=2)
        t_k = device_ms(lambda: window_match(*args))
        t_p = device_ms(lambda: window_match_plain(*args), reps=2)
        b_s = starts_bytes(s_args) / HBM_BYTES_PER_S * 1e3
        b = k1_bytes(args) / HBM_BYTES_PER_S * 1e3
        for k, v in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", b),
                     ("starts_ms", t_s), ("starts_plain_ms", t_sp),
                     ("starts_bound_ms", b_s)):
            tot[k] += v
        g, nt = starts.shape
        idx = window_match(*args)
        plans.append({
            "kind": kind, "n_in": hi.shape[0], "n_out": o_hi.shape[0],
            "G": g, "M": len(deltas[0]), "tile": tile,
            "coverage": blocks * window,
            "k1_rows_per_block": match.rows_per_block(nt, tile, g),
            "present": int((idx >= 0).sum()),
            "starts_ms": t_s, "starts_plain_ms": t_sp, "starts_bound_ms": b_s,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b,
            "k1_plus_pass_ms": t_k + t_s})
    line = {"phase": "k1", "plans_checked": checked, "plans": plans, **tot,
            "k1_plus_pass_ms": tot["ms"] + tot["starts_ms"],
            "roofline_share": tot["bound_ms"] / tot["ms"]}
    k1 = {"max_abs_err": 0, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
          "bound_ms": tot["bound_ms"], "calls_per_forward": len(plans)}
    ws = {"max_abs_err": 0, "ms": tot["starts_ms"],
          "plain_ms": tot["starts_plain_ms"],
          "bound_ms": tot["starts_bound_ms"], "calls_per_forward": len(plans)}
    return line, k1, ws


def im2col_matmul(feats, starts, idx, w):
    """The same function as K2 by two PyTorch calls, for information: the
    gathered rows of every term side by side ([n_out, G M C], absent
    entries on a zero row; ``index_select``) times ``w`` as one
    [G M C, Cout] matrix. Returns a function of no arguments that runs
    the two calls; the index and the zero row are made beforehand."""
    import torch

    g, nt, m, tile = idx.shape
    n_rows, c = feats.shape
    rows = starts[:, :, None, None].long() + idx.long()
    rows = torch.where((idx >= 0) & (rows < n_rows), rows, n_rows)
    flat = rows.permute(1, 3, 0, 2).reshape(-1).contiguous()
    ext = torch.cat([feats, feats.new_zeros(1, c)])
    wm = w.reshape(g * m * c, -1)

    def run():
        return torch.matmul(
            torch.index_select(ext, 0, flat).reshape(nt * tile, g * m * c),
            wm)
    return run


def phase_k2(rec) -> tuple[dict, dict]:
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        tc,
        window_gather_matmul,
        window_gather_matmul_plain,
    )

    shapes: dict = {}
    err32 = err16 = 0.0
    kernel_ms = plain_ms = bound_ms = composite_ms = 0.0
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
        if not torch.equal(window_gather_matmul(feats, starts, idx, w),
                           got16):
            raise PhaseError(f"K2: two bf16 launches differ at {key}")
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
        t_c = device_ms(im2col_matmul(feats, starts, idx, w), reps=2)
        nbytes, flops = k2_work(feats, starts, idx, w)
        peak = PEAK_FLOPS[str(feats.dtype).replace("torch.", "")]
        b = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
        kernel_ms, plain_ms, bound_ms, composite_ms = (
            kernel_ms + t_k, plain_ms + t_p, bound_ms + b, composite_ms + t_c)
        choice = tc.gather_choice(feats.dtype, nt * tile, c, cout, g * m)
        if choice.core != "tensor":
            raise PhaseError(f"K2 at {key} of the bf16 forward has "
                             f"{feats.dtype} inputs")
        s = shapes.setdefault(str(key), {
            "C": c, "Cout": cout, "G": g, "M": m, "tile": tile,
            "blocks": blocks, "rows": [], "calls": 0, "ms": 0.0,
            "plain_ms": 0.0, "composite_ms": 0.0, "bound_ms": 0.0,
            "bound_by": None, "max_err_f32": 0.0, "max_err_bf16": 0.0,
            "present": 0, "entries": 0, "core": [],
            "core_f32": tc.gather_choice(torch.float32, 0, c, cout,
                                         1).describe()["core"],
        })
        s["calls"] += 1
        s["ms"] += t_k
        s["plain_ms"] += t_p
        s["composite_ms"] += t_c
        s["bound_ms"] += b
        s["roofline_share"] = s["bound_ms"] / s["ms"]
        s["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / peak else "operations")
        s["max_err_f32"] = max(s["max_err_f32"], float(d32.max()))
        s["max_err_bf16"] = max(s["max_err_bf16"], float(d16.max()))
        s["present"] += int((idx >= 0).sum())
        s["entries"] += idx.numel()
        if nt * tile not in s["rows"]:
            s["rows"].append(nt * tile)
            s["core"].append({"rows": nt * tile, **choice.describe()})
        if bad32 or bad16:
            raise PhaseError(f"K2 outside tolerance at {s}: {bad32} f32 and "
                             f"{bad16} bf16 elements")
    if not pad_checked:
        raise PhaseError("no C=27 call was recorded")
    line = {"phase": "k2", "shapes": list(shapes.values()),
            "max_abs_err_f32": err32, "max_abs_err_bf16": err16,
            "deterministic": True, "ms": kernel_ms, "plain_ms": plain_ms,
            "composite_ms": composite_ms, "bound_ms": bound_ms,
            "roofline_share": bound_ms / kernel_ms,
            "tolerance": {"f32": [K2_F32_TOL, K2_F32_TOL],
                          "bf16": [K2_BF16_ATOL, K2_BF16_RTOL]}}
    by_bytes = sum(s["bound_ms"] for s in shapes.values()
                   if s["bound_by"] == "bytes")
    return line, {"max_abs_err": err32, "max_abs_err_bf16": err16,
                  "deterministic": True, "ms": kernel_ms,
                  "plain_ms": plain_ms, "composite_ms": composite_ms,
                  "bound_ms": bound_ms,
                  "bound_by": ("bytes" if by_bytes >= bound_ms / 2
                               else "operations"),
                  "core": "tensor cores (bf16), CUDA cores (f32)",
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


ROW_ROUTE_MODEL = "Res16UNet14A"
# the row path's contexts: the serving_8k knobs with the method "row"
# (kernel maps through the grid index) and "search" (by sort and search)
ROW_ROUTES = {"row_grid": dict(method="row", grid_extent=128),
              "row_search": dict(method="search")}


def phase_row_route(card: str, device: str = "cuda") -> tuple[dict, dict]:
    """Res16UNet14A at ``serving_8k`` in f32 with seeded weights, through
    ``serve.eval_step``: on its windowed path (the preset's knobs) and,
    with the same weights, on the row path for every conv (method "row"
    with the grid index, and "search"), whose logits must agree with the
    windowed path's within MODEL_TOL x max|logit|. Launch counts are
    reset just before the row-path forwards and read just after: K6 must
    launch and no windowed kernel may. Reports each route's forward
    device time, its K6 launches and the convs on each route."""
    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import serve
    from nerf_downstream_tpu_torch.models.mink.layers import (
        SparseConv,
        SparseConvTranspose,
    )
    from nerf_downstream_tpu_torch.ops import kernels

    model = serve.build_segmenter(ROW_ROUTE_MODEL, ctx_preset="serving_8k",
                                  device=device, seed=0,
                                  compute_dtype=torch.float32)
    batch = serve.to_device(
        serve.make_batch("serving_8k", np.random.default_rng(2)), device)
    convs = [m for m in model.modules()
             if isinstance(m, (SparseConv, SparseConvTranspose))]
    windowed_ctx = dict(model.ctx_kwargs)
    ref, _ = serve.eval_step(model, batch)
    valid = batch["mask"]
    scale = float(ref[valid].abs().max())
    line = {"phase": "row_route", "card": card, "model": ROW_ROUTE_MODEL,
            "preset": "serving_8k", "dtype": "float32",
            "rows": int(valid.sum()), "max_abs_logit": scale,
            "tolerance": MODEL_TOL * scale,
            "windowed": {"routes": sorted({m.route for m in convs
                                           if m.route}),
                         "forward_ms": device_ms(
                             lambda: serve.eval_step(model, batch), reps=3)}}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for name, knobs in ROW_ROUTES.items():
        model.ctx_kwargs = dict(windowed_ctx, **knobs)
        before = kernels.launch_counts()["row_gather_matmul"]
        logits, _ = serve.eval_step(model, batch)
        k6 = kernels.launch_counts()["row_gather_matmul"] - before
        err = float((logits[valid] - ref[valid]).abs().max())
        line[name] = {"max_abs_err": err, "k6_launches": k6,
                      "routes": sorted({m.route for m in convs
                                        if m.route})}
        if not (np.isfinite(err) and err <= MODEL_TOL * scale
                and line[name]["routes"] == ["row"]):
            raise PhaseError(f"row_route: {name} off the windowed path: "
                             f"{line}")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    line["launches"] = counts
    for name, knobs in ROW_ROUTES.items():
        model.ctx_kwargs = dict(windowed_ctx, **knobs)
        line[name]["forward_ms"] = device_ms(
            lambda: serve.eval_step(model, batch), reps=3)
    model.ctx_kwargs = windowed_ctx
    if counts["row_gather_matmul"] <= 0 or any(
            counts[k] for k in WINDOWED_KERNELS):
        raise PhaseError(f"row_route: launches {counts}")
    return line, counts


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
    cores = tensor_core_check("train_64k", task.model, counts)
    line = {"phase": "train", "card": card, "preset": "train_64k",
            "dtype": str(dtype), "steps": TRAIN_STEPS,
            "valid_rows": int(batch["mask"].sum()), "ms": times,
            "ms_median_after_first": float(np.median(times[1:])),
            "losses": losses, "launches": counts, "launches_by_core": cores,
            "launches_per_step": {k: v / TRAIN_STEPS
                                  for k, v in counts.items()}}
    if not np.isfinite(losses).all():
        raise PhaseError(f"non-finite training loss: {line}")
    if len(set(losses)) != len(losses):
        raise PhaseError(f"repeated training losses: {line}")
    want = {"window_bwd": K3_PER_STEP * TRAIN_STEPS,
            "window_dw": K4_PER_STEP * TRAIN_STEPS}
    for name in TRAIN_KERNELS:
        c = counts[name]
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

    def step() -> None:
        nonlocal state
        state, _ = train3d.train_step(task, state, batch)

    line["sync"] = sync_count("train_64k", step)
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
        tc,
        window_bwd,
        window_bwd_plain,
        window_dw,
        window_gather_matmul,
    )

    shapes: dict = {}
    err = {"d_feats_f32": 0.0, "d_feats_bf16": 0.0, "d_w_f32": 0.0,
           "d_w_bf16": 0.0, "d_w_vs_k4": 0.0}
    worst_rel = 0.0
    deterministic = True
    kernel_ms = plain_ms = bound_ms = by_bytes = d_feats_ms = 0.0
    for c3 in rec.k3:
        args = [c3[k] for k in ("g_out", "feats", "inv_starts", "inv_idx",
                                "w_t")]
        dt = args[0].dtype
        if {a.dtype for a in (args[0], args[1], args[4])} != {torch.bfloat16}:
            raise PhaseError("K3 call of the bf16 step without bf16 inputs")
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
        # the d_feats half alone: K2's wrapper on the inverse plan
        t_f = device_ms(lambda: window_gather_matmul(
            args[0], args[2], args[3], args[4]))
        b, by = bound(*k3_work(c3), dt)
        kernel_ms, plain_ms, bound_ms = (kernel_ms + t_k, plain_ms + t_p,
                                         bound_ms + b)
        by_bytes += b if by == "bytes" else 0.0
        s = shapes.setdefault(str(key), {
            "C": c, "Cout": cout, "G": g, "M": m, "tile": tile,
            "n_in": nt * tile, "n_out": c3["g_out"].shape[0], "calls": 0,
            "ms": 0.0, "d_feats_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": by, "present": 0,
            "core": {"d_feats": tc.gather_choice(dt, nt * tile, cout, c,
                                                 g * m).describe(),
                     "d_w": tc.dw_choice(dt, nt * tile, c, cout,
                                         g * m).describe(nt * tile)},
            "core_f32": tc.CUDA_CORES})
        s["calls"] += 1
        s["ms"] += t_k
        s["d_feats_ms"] += t_f
        s["plain_ms"] += t_p
        s["bound_ms"] += b
        s["roofline_share"] = s["bound_ms"] / s["ms"]
        d_feats_ms += t_f
        s["present"] += present_entries(c3["inv_starts"], c3["inv_idx"],
                                        c3["g_out"].shape[0])
        for name, bad, rel in checks:
            if bad or not rel <= DW_TOL:
                raise PhaseError(f"K3 ({name}) outside tolerance at {s}: "
                                 f"{bad} d_feats elements, d_w {rel:.3g} of "
                                 "its largest")
    if not deterministic:
        raise PhaseError("K3: two launches on the same inputs differ")
    line = {"phase": "k3", "calls": len(rec.k3),
            "shapes": list(shapes.values()), "max_abs_err": err,
            "d_w_worst_of_max": worst_rel, "deterministic": deterministic,
            "ms": kernel_ms, "d_feats_ms": d_feats_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "roofline_share": bound_ms / kernel_ms,
            "tolerance": {"d_feats": DFEATS_TOL, "d_w_of_max": DW_TOL}}
    return line, {"max_abs_err": err["d_feats_f32"],
                  "max_abs_err_d_w": err["d_w_f32"],
                  "max_abs_err_bf16": err["d_feats_bf16"],
                  "d_w_vs_k4_max_abs": err["d_w_vs_k4"],
                  "deterministic": deterministic, "ms": kernel_ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": ("bytes" if by_bytes >= bound_ms / 2
                               else "operations"),
                  "core": "tensor cores (bf16), CUDA cores (f32)",
                  "calls_per_step": len(rec.k3)}


def phase_k4(rec) -> tuple[dict, dict]:
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        tc,
        window_dw,
        window_dw_plain,
    )

    calls = []
    err = {"f32": 0.0, "bf16": 0.0}
    deterministic = True
    kernel_ms = plain_ms = bound_ms = 0.0
    by = "bytes"
    for args in rec.k4:
        if {args[0].dtype, args[3].dtype} != {torch.bfloat16}:
            raise PhaseError("K4 call of the bf16 step without bf16 inputs")
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
        g, nt, m, tile = idx.shape
        c, cout = feats.shape[1], g_out.shape[1]
        calls.append({"C": c, "Cout": cout, "G": g, "M": m,
                      "rows": g_out.shape[0],
                      "present": present_entries(starts, idx,
                                                 feats.shape[0]),
                      "core": tc.dw_choice(feats.dtype, nt * tile, c, cout,
                                           g * m).describe(nt * tile),
                      "core_f32": tc.dw_choice(torch.float32, nt * tile, c,
                                               cout, g * m)
                      .describe(nt * tile),
                      "ms": t_k, "plain_ms": t_p, "bound_ms": b,
                      "bound_by": by, "roofline_share": b / t_k,
                      "d_w_of_max": rels})
        if not max(rels.values()) <= DW_TOL:
            raise PhaseError(f"K4 outside tolerance: {calls[-1]}")
    if not deterministic:
        raise PhaseError("K4: two launches on the same inputs differ")
    line = {"phase": "k4", "calls": calls, "max_abs_err": err,
            "deterministic": deterministic, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "roofline_share": bound_ms / kernel_ms,
            "tolerance": {"d_w_of_max": DW_TOL}}
    return line, {"max_abs_err": err["f32"], "max_abs_err_bf16": err["bf16"],
                  "deterministic": deterministic, "ms": kernel_ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": by, "core": "tensor cores (bf16), CUDA cores "
                  "(f32)", "calls_per_step": len(rec.k4)}


def grad_gap(grads, ref) -> float:
    """Largest difference of two gradient sets, as a fraction of each
    parameter's largest reference entry."""
    return max(float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
               for g, r in zip(grads, ref))


def nondeterministic_ops(build, batch) -> dict:
    """Which ops make whole training steps differ. Two kernel-path steps
    from the same fresh model run under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the ops
    PyTorch names as nondeterministic (each warning's first sentence,
    where it was raised — a backward op's at the ``backward`` call — and
    how often), a control op that must be named (``torch.histc``), and
    whether the two steps' gradients are then bit-identical (in this mode
    the ops that have a deterministic implementation take it without a
    warning)."""
    import collections
    import warnings

    import torch

    from nerf_downstream_tpu_torch import train3d

    sites = collections.Counter()
    grads = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for _ in range(2):
                task, state = build()
                state, _ = train3d.train_step(task, state, batch)
                grads.append([p.grad.clone()
                              for p in state.model.parameters()])
            control = len(caught)
            torch.histc(torch.ones(8, device="cuda"))
            control = len(caught) > control
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    for w in caught[:-1] if control else caught:
        msg = str(w.message)
        if "determinis" not in msg:
            continue
        where = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
        sites[(msg.split(". ")[0][:200], where)] += 1
    return {"named": [{"op": op, "raised_at": where, "count": n}
                      for (op, where), n in sites.most_common()],
            "control_histc_named": bool(control),
            "two_steps_bit_identical": all(
                torch.equal(a, b) for a, b in zip(*grads)),
            "two_steps_grad_gap_of_max": grad_gap(grads[0], grads[1])}


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
            grads=[p.grad.clone() for p in state.model.parameters()],
            params=[p.detach().clone() for p in state.model.parameters()])

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
    # every accumulating scatter of the step adds in a fixed order: two
    # kernel-path steps from the same state must agree bit for bit
    ka, kb = runs["kernel"], runs["kernel_again"]
    repro = {
        "loss": ka["loss"] == kb["loss"],
        "grads": all(torch.equal(x, y)
                     for x, y in zip(ka["grads"], kb["grads"])),
        "updated_weights": all(torch.equal(x, y)
                               for x, y in zip(ka["params"], kb["params"])),
        "running_stats": all(torch.equal(v, kb["stats"][k])
                             for k, v in ka["stats"].items()),
    }

    nondet = nondeterministic_ops(build, batch)
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
            "kernel_steps_bit_identical": repro,
            "nondeterministic_ops": nondet,
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
    if not all(repro.values()):
        raise PhaseError(f"two kernel-path training steps differ: {repro}")
    return line


# the cli_train phase's synthetic PeRFception-ScanNet tree: 12 train and 4
# val surface shells of 9,000 voxels at reso 128, scene scale 100 / 128 (one
# voxel per finest-level unit), so a batch of 8 holds 50,000-65,536 valid
# finest rows (train_64k's scale, on which the config's caps were measured)
CLI_TREE = dict(n_train=12, n_val=4, n_voxels=9000, reso=(128, 128, 128),
                scene_scale=100 / 128)
CLI_ROWS = (50_000, 65_536)
CLI_STEPS, CLI_RESUME_STEPS, CLI_VAL_EVERY = 6, 8, 3
CLI_KERNELS = ("window_starts", "window_match", "window_gather_matmul",
               "window_bwd", "window_dw")


class CliStepRecorder(TrainRecorder):
    """Records what ``TrainRecorder`` records, and the inputs of every K2
    call of the step's forward."""

    def __enter__(self):
        from nerf_downstream_tpu_torch.ops import window_conv

        super().__enter__()
        self.k2 = []
        self._gmm = window_conv.window_gather_matmul
        gmm = self._gmm

        def rec_gmm(feats, starts, idx, w):
            self.k2.append((feats.detach().clone(), starts, idx,
                            w.detach().clone()))
            return gmm(feats, starts, idx, w)

        window_conv.window_gather_matmul = rec_gmm
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.ops import window_conv

        window_conv.window_gather_matmul = self._gmm
        return super().__exit__(*exc)


class CliProbe:
    """Wraps the training step, the validation pass and the profiler of
    the port's training CLI: each step's wall time (a synchronise on
    either side), its batch's valid finest-level rows after the device
    augmentation, its loss, the last (task, state, batch), each validation
    pass's wall time, and the momentum buffers the first step of a resumed
    run starts from against ``resume_trace`` (the checkpoint's).
    ``on_step``, where set, sees each (task, state, batch) before its
    step."""

    def __init__(self, task_name: str = "SegmentationTraining"):
        self.task_name = task_name
        self.steps: list[tuple[int, float]] = []
        self.losses: list[float] = []
        self.rows: list[int] = []
        self.val_ms: list[float] = []
        self.profilers: list = []
        self.last = None
        self.resume_trace = None
        self.resume_check = None
        self.on_step = None  # f(task, state, batch) before each step

    def __enter__(self):
        import torch

        from nerf_downstream_tpu_torch.co3d_3d import train as cli
        from nerf_downstream_tpu_torch.train import loop, modules

        probe = self
        task_cls = getattr(modules, self.task_name)
        self._own_step = "train_step" in vars(task_cls)
        self._saved = (task_cls.train_step, loop.Trainer.validate,
                       cli.SumProfiler)
        step_fn, validate, prof_cls = self._saved

        def train_step(task, state, batch):
            if probe.resume_trace is not None and probe.resume_check is None:
                probe.resume_check = {
                    "step": int(state.step),
                    "momentum_bit_equal": all(
                        torch.equal(state.optimizer.state[p][
                            "momentum_buffer"].cpu(), probe.resume_trace[n])
                        for n, p in state.model.named_parameters())}
            if probe.on_step is not None:
                probe.on_step(task, state, batch)
            aug = task.augment(batch, state.step)
            vox = torch.floor(aug["coordinates"][aug["mask"]])
            probe.rows.append(int(torch.unique(vox, dim=0).shape[0]))
            step = int(state.step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(task, state, batch)
            torch.cuda.synchronize()
            probe.steps.append((step, (time.perf_counter() - t0) * 1e3))
            probe.losses.append(float(out[1]["loss"]))  # after the sync
            probe.last = (task, out[0], batch)
            return out

        def timed_validate(trainer, state, phase="val"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = validate(trainer, state, phase)
            torch.cuda.synchronize()
            probe.val_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        class Profiler(prof_cls):
            def __init__(self):
                super().__init__()
                probe.profilers.append(self)

        task_cls.train_step = train_step
        loop.Trainer.validate = timed_validate
        cli.SumProfiler = Profiler
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.co3d_3d import train as cli
        from nerf_downstream_tpu_torch.train import loop, modules

        task_cls = getattr(modules, self.task_name)
        step_fn, loop.Trainer.validate, cli.SumProfiler = self._saved
        if self._own_step:
            task_cls.train_step = step_fn
        else:  # the step is inherited: drop the wrapper
            del task_cls.train_step
        return False


def _finite_nonzero(where: str, name: str, ts) -> None:
    """Raise unless every tensor is finite and some entry is non-zero (a
    comparison on such inputs would hold nothing)."""
    import torch

    if not all(bool(torch.isfinite(t).all()) for t in ts):
        raise PhaseError(f"{where}: non-finite {name} inputs")
    if not any(bool((t != 0).any()) for t in ts):
        raise PhaseError(f"{where}: all-zero {name} inputs")


def cli_kernels_f32(rec, where: str = "cli_train",
                    scaled_dw: bool = False) -> dict:
    """Every K1, pass, K2, K3 and K4 call of one recorded f32 step of the
    CLI path against its plain version (K1 and the pass equal; K2 and
    K3's d_feats within 1e-5 x max + 1e-5 relative, d_w within 1e-5 of
    each (g, m)'s largest), and its device ms, plain ms and bound summed
    over the step, with its core. A kernel the step does not call gets a
    row of zero calls. ``scaled_dw`` holds K3's and K4's d_w to the f32
    sum bound instead, ``K2_F32_TOL`` x (1 + the sum of the absolute
    products) of each entry, as ``k3_dw_step`` does at ``cli_semseg``'s
    2 M rows: over hundreds of thousands of rows two summation orders
    part by more than 1e-5 of a slice's largest entry where terms
    cancel (``worst_err`` still reports that share)."""
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        tc,
        window_bwd,
        window_bwd_plain,
        window_dw,
        window_dw_plain,
        window_gather_matmul,
        window_gather_matmul_plain,
        window_match,
        window_match_plain,
        window_starts,
        window_starts_plain,
    )

    f32 = torch.float32
    for args in rec.k2 + rec.k4:
        if args[0].dtype != f32:
            raise PhaseError(f"{where}: a K2 or K4 call without f32 inputs")
    if any(c3["g_out"].dtype != f32 for c3 in rec.k3):
        raise PhaseError(f"{where}: a K3 call without f32 inputs")
    # a comparison on non-finite or all-zero inputs would hold nothing
    for name, ts in (("K2", [a[0] for a in rec.k2]),
                     ("K3", [c["g_out"] for c in rec.k3]),
                     ("K4", [a[3] for a in rec.k4])):
        if ts:
            _finite_nonzero(where, name, ts)
    out = {}

    def tally(name, calls, run, plain, work, check):
        row = {"calls": len(calls), "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bound_by": "bytes", "worst_err": 0.0}
        for args in calls:
            err = check(args)
            if not err == err:  # NaN
                raise PhaseError(f"{where}: {name} gave NaN against its "
                                 "plain version")
            row["worst_err"] = max(row["worst_err"], err)
            row["ms"] += device_ms(lambda: run(args))
            row["plain_ms"] += device_ms(lambda: plain(args), reps=2)
            b, row["bound_by"] = work(args)
            row["bound_ms"] += b
        out[name] = row

    def exact(fn, plain):
        def check(args):
            got, want = fn(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise PhaseError(f"{where}: {fn.__name__} differs from "
                                 "its plain version")
            return 0.0
        return check

    tally("window_starts", rec.starts, lambda a: window_starts(*a),
          lambda a: window_starts_plain(*a),
          lambda a: (starts_bytes(a) / HBM_BYTES_PER_S * 1e3, "bytes"),
          exact(window_starts, window_starts_plain))
    tally("window_match", rec.k1, lambda a: window_match(*a),
          lambda a: window_match_plain(*a),
          lambda a: (k1_bytes(a) / HBM_BYTES_PER_S * 1e3, "bytes"),
          exact(window_match, window_match_plain))

    def k2_check(a):
        got, want = window_gather_matmul(*a), window_gather_matmul_plain(*a)
        if dfeats_bad(got, want, f32):
            raise PhaseError(f"{where}: K2 (f32) off its plain version")
        return float((got - want).abs().max())

    tally("window_gather_matmul", rec.k2, lambda a: window_gather_matmul(*a),
          lambda a: window_gather_matmul_plain(*a),
          lambda a: bound(*k2_work(*a), f32), k2_check)

    def k3_args(c3):
        return [c3[k] for k in ("g_out", "feats", "inv_starts", "inv_idx",
                                "w_t")]

    def dw_bad(plain, args, got, want):
        rel, _ = dw_err(got, want)
        if not scaled_dw:
            return rel > DW_TOL, rel
        scale = plain(*[a.abs() if a.is_floating_point() else a
                        for a in args])
        scale = scale[1] if isinstance(scale, tuple) else scale
        return bool(((got - want).abs() > K2_F32_TOL * (1 + scale)).any()), rel

    def k3_check(c3):
        args = k3_args(c3)
        (got_f, got_w), (want_f, want_w) = (window_bwd(*args),
                                            window_bwd_plain(*args))
        bad_w, rel = dw_bad(window_bwd_plain, args, got_w, want_w)
        bad_f = dfeats_bad(got_f, want_f, f32)
        if bad_f or bad_w:
            raise PhaseError(f"{where}: K3 (f32) off its plain version: "
                             f"{bad_f} d_feats entries; d_w {rel} of a "
                             "slice's largest")
        return rel

    tally("window_bwd", rec.k3, lambda c3: window_bwd(*k3_args(c3)),
          lambda c3: window_bwd_plain(*k3_args(c3)),
          lambda c3: bound(*k3_work(c3), f32), k3_check)

    def k4_check(a):
        bad, rel = dw_bad(window_dw_plain, a, window_dw(*a),
                          window_dw_plain(*a))
        if bad:
            raise PhaseError(f"{where}: K4 (f32) off its plain version: "
                             f"{rel} of a slice's largest")
        return rel

    tally("window_dw", rec.k4, lambda a: window_dw(*a),
          lambda a: window_dw_plain(*a), lambda a: bound(*k4_work(*a), f32),
          k4_check)
    for name in ("window_gather_matmul", "window_bwd", "window_dw"):
        out[name]["core"] = tc.CUDA_CORES
    for name in ("window_starts", "window_match"):
        out[name].update(core="cuda cores (int32 searches)", dtype="int32")
    for name in ("window_gather_matmul", "window_bwd", "window_dw"):
        out[name]["dtype"] = "float32"
    return out


def cli_extra_steps(where: str, line: dict, task, state, batch, dm,
                    recorder_cls, host_batches: int):
    """More steps of a CLI path's task, written into ``line``: host ms
    per batch of ``dm`` on one worker (``host_batches`` batches after a
    first), one step's synchronising calls, a profile of one step (device
    time, busy share against the run's median step, device ops, the
    largest device kernels), and one step under ``recorder_cls``, which is
    returned. Fails on a non-finite loss of these steps or a profile
    without device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    it = dm.train_batches()
    next(it)
    t0 = time.perf_counter()
    for _ in range(host_batches):
        next(it)
    line["host_ms_per_batch_one_worker"] = (
        (time.perf_counter() - t0) * 1e3 / host_batches)

    extra_losses = []  # read after the timed and counted steps

    def step() -> None:
        nonlocal state
        state, mets = task.train_step(state, batch)
        extra_losses.append(mets["loss"].detach())

    line["sync"] = sync_count(where, step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_profiled = (time.perf_counter() - t0) * 1e3
    rows = device_rows(p, 1)
    device = sum(r[0] for r in rows)
    if device <= 0:
        raise PhaseError(f"{where}: the profiler saw no device time")
    line["profile"] = {
        "wall_ms_per_step_profiled": wall_profiled,
        "device_ms_per_step": device,
        "device_busy_share": device / line["ms_median_after_first"],
        "device_ops_per_step": sum(r[1] for r in rows),
        "top_device": [{"name": k[:90], "per_step": c, "ms": m}
                       for m, c, k in rows[:12]]}
    with recorder_cls() as rec:
        step()
    line["extra_step_losses"] = [float(v) for v in extra_losses]
    if not np.isfinite(line["extra_step_losses"]).all():
        raise PhaseError(f"{where}: non-finite loss in the extra steps: "
                         f"{line['extra_step_losses']}")
    return rec


def phase_cli_train(card: str, device: str = "cuda", bindings=(),
                    keep: dict | None = None) -> tuple[dict, dict]:
    """The port's training CLI (``co3d_3d.train``) on the flagship configs
    at full width, as a user runs it: a synthetic PeRFception-ScanNet tree
    written by the port's own writer (``CLI_TREE``), ``CLI_STEPS`` steps
    validating every ``CLI_VAL_EVERY`` and testing the best checkpoint,
    then ``--resume`` to ``CLI_RESUME_STEPS``. Launch counts are reset
    just before the first run and read just after the second. Fails
    unless: every loss is finite (the Trainer raises otherwise), the
    checkpoints, ``eval_results.json`` and both metric logs exist, the
    resumed run starts at step ``CLI_STEPS`` from the checkpoint's
    momentum buffers bit for bit, every batch holds ``CLI_ROWS`` valid
    finest rows, every conv computes in f32 (the config binds no compute
    type), and K1-K4 each launched. Then one more step is profiled, its
    synchronising calls counted, and its K1-K4 calls recorded, held
    against their plain versions and timed (``cli_kernels_f32``).
    ``device`` and ``bindings`` (more ``--ginb``) serve a rehearsal on
    the CPU at a narrow width. With ``keep`` (a dict) the tree and the
    run's outputs stay on disk for phase ``cli_eval``, which removes them,
    and ``keep`` gets their paths, the CLI's arguments and the logged
    validations."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.co3d_3d import train as cli
    from nerf_downstream_tpu_torch.data.synthetic import write_scannet_tree
    from nerf_downstream_tpu_torch.models.mink.layers import (
        SparseConv,
        SparseConvTranspose,
    )
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train import checkpoints

    tmp = tempfile.mkdtemp(prefix="cli_train_")
    try:
        t0 = time.perf_counter()
        root = write_scannet_tree(tmp, np.random.default_rng(0), **CLI_TREE)
        tree_s = time.perf_counter() - t0
        save = os.path.join(tmp, "exp")
        configs = [os.path.join(REPO, "co3d_3d", "configs", name)
                   for name in ("scannet_plenoxel.gin",
                                "scannet_feature_sh.gin")]
        args = [a for c in configs for a in ("--ginc", c)]
        for b in (f'PlenoxelScannetDataset.data_root = "{root}"',
                  "PlenoxelScannetDataset.downsample_stride = 1",
                  f"train.val_every_n_steps = {CLI_VAL_EVERY}",
                  "train.log_every_n_steps = 1", "train.evaluate = True",
                  'train.loggers = ["csv", "jsonl"]', *bindings):
            args += ["--ginb", b]
        base = list(args)
        args += ["--save_path", save, "--seed", "0", "--device", device]
        stdout = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with CliProbe() as probe, contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            gin.clear_config()
            cli.main(args + ["--ginb", f"train.max_steps = {CLI_STEPS}"])
            first_s = time.perf_counter() - t0
            last = checkpoints.load_checkpoint(os.path.join(save,
                                                            "last.ckpt"))
            inner = last["opt_state"]["1"]
            trace = convert.flax_to_state_dict(probe.last[0].model,
                                               inner["0"]["trace"])
            probe.resume_trace = {k: v for k, v in trace.items()}
            t0 = time.perf_counter()
            gin.clear_config()
            cli.main(args + ["--ginb", f"train.max_steps = "
                                       f"{CLI_RESUME_STEPS}", "--resume"])
            resume_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        task, state, batch = probe.last
        run = os.path.join(save, f"b8x1-{type(task.model).__name__}")
        files = {name: os.path.exists(os.path.join(d, name)) for d, name in (
            (save, "last.ckpt"), (save, "best.ckpt"),
            (save, "eval_results.json"), (run, "metrics.csv"),
            (run, "metrics.jsonl"))}
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logged = [json.loads(ln) for ln in f]
        train_losses = [r["train/loss"] for r in logged if "train/loss" in r]
        val = [{k: r[k] for k in ("step", "val/loss", "val/mIoU", "val/OA")}
               for r in logged if "val/mIoU" in r]
        with open(os.path.join(save, "eval_results.json")) as f:
            results = json.load(f)
        text = stdout.getvalue()
        types = {m.compute_dtype for m in task.model.modules()
                 if isinstance(m, (SparseConv, SparseConvTranspose))}
        steps = [s for s, _ in probe.steps]
        ms = [m for _, m in probe.steps]
        prof = probe.profilers[-1]
        line = {
            "phase": "cli_train", "card": card, "entry":
            "python -m nerf_downstream_tpu_torch.co3d_3d.train",
            "configs": ["co3d_3d/configs/scannet_plenoxel.gin",
                        "co3d_3d/configs/scannet_feature_sh.gin"],
            "tree": dict(CLI_TREE, seconds=tree_s),
            "dtype": "float32 (the config binds no compute type; every "
                     "conv on the CUDA cores)",
            "capacity": int(batch["mask"].shape[0]),
            "valid_finest_rows": probe.rows,
            "steps": steps, "ms": ms,
            "ms_median_after_first": float(np.median(ms[1:])),
            "run_seconds": [first_s, resume_s],
            "train_losses": train_losses, "val": val,
            "val_pass_ms": probe.val_ms,
            "host_ms_per_batch_waited": prof.recorded_time(
                "get_train_batch") * 1e3,
            "resume": probe.resume_check, "files": files,
            "eval_results_mIoU": results.get("val/mIoU"),
            "iou_tables_printed": text.count("miou: "),
            "launches": counts,
        }
        ok = (all(files.values())
              and np.isfinite(train_losses).all()
              and all(np.isfinite(v["val/loss"]) for v in val)
              and len(val) >= 4 and line["iou_tables_printed"] >= 4
              and steps == list(range(CLI_RESUME_STEPS))
              and probe.resume_check == {"step": CLI_STEPS,
                                         "momentum_bit_equal": True}
              and all(CLI_ROWS[0] <= r <= CLI_ROWS[1] for r in probe.rows)
              and types == {torch.float32}
              and all(counts[k] > 0 for k in CLI_KERNELS))
        if not ok:
            raise PhaseError(f"cli_train: {line}")

        # one more step of the same task
        from nerf_downstream_tpu_torch.data.data_module import DataModule

        dm = DataModule(batch_size=8, val_batch_size=2, train_num_workers=1,
                        ignore_label=-255, capacity=line["capacity"])
        rec = cli_extra_steps("cli_train", line, task, state, batch, dm,
                              CliStepRecorder, 3)
        line["kernels_per_step"] = cli_kernels_f32(rec)
        if keep is not None:
            keep.update(tmp=tmp, args=base, save=save, val=val,
                        val_batch_size=2)
        return line, counts
    finally:
        gin.clear_config()
        if keep is None or "tmp" not in keep:
            shutil.rmtree(tmp, ignore_errors=True)


# phase cli_methods: the flagship CLI under the other conv methods, from
# cli_train's best checkpoint on cli_train's batches (its tree, seed 0)
METHODS = ("window", "block", "block_resident")
METHOD_STEPS = 3
METHOD_TOL = 1e-4  # step-1 loss (relative) and eval logits (of max|logit|)
# What CLI_TREE needs beyond the flagship configs, measured on its first
# three batches on the CPU: a plan from a kernel map ("window") has no
# escape list, and at the config's window_size 128 (two blocks) 235,024-
# 270,927 entries of a stride-1 map fall outside their windows (1,654-
# 2,358 at 256, none at 512). The batches fill 3,351-3,424 / 842-873 /
# 243-246 / 69-83 / 27-36 blocks at strides 1-16. The config's divisor 3
# caps them at capacity / (3 stride^2): 43,690 blocks at stride 1, 13x
# what they fill (every cell held densely), and 85 at stride 8, barely
# above them; divisor 1 ran the card out of its 80 GB at stride 1.
# block_caps bind about twice the filled blocks at each level.
BLOCK_CAPS = "CoordinateContext.block_caps = (8192, 2048, 512, 256, 128)"
METHOD_BINDINGS = {
    "auto": (),
    "window": ('CoordinateContext.method = "window"',
               "CoordinateContext.window_size = 512"),
    "block": ('CoordinateContext.method = "block"', BLOCK_CAPS),
    "block_resident": ('CoordinateContext.method = "block_resident"',
                       BLOCK_CAPS),
}
METHOD_ROUTE = {"auto": "windowed", "window": "window", "block": "block",
                "block_resident": "block_resident"}


def profiled_rows(where: str, task, state, batch) -> tuple:
    """One training step under the profiler: (state, wall ms, its
    ``device_rows``). Fails on a profile without device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = task.train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(p, 1)
    if sum(r[0] for r in rows) <= 0:
        raise PhaseError(f"{where}: the profiler saw no device time")
    return state, wall, rows


def profiled_step(where: str, task, state, batch) -> tuple:
    """One training step under the profiler: (state, wall ms, device ms,
    device ops)."""
    state, wall, rows = profiled_rows(where, task, state, batch)
    return state, wall, sum(r[0] for r in rows), sum(r[1] for r in rows)


def phase_cli_methods(card: str, kept: dict, device: str = "cuda",
                      bindings=()) -> tuple[dict, dict]:
    """The flagship training CLI (phase cli_train's configs, tree and
    seed) from cli_train's best checkpoint for ``METHOD_STEPS`` steps,
    once on the default route ("auto": fully windowed) and once under each
    of ``METHODS`` with ``METHOD_BINDINGS``; launch counts reset before
    each run and read after (the phase's launches are their sum). Per
    method: the losses, wall ms per step, the routes its convs took, its
    launches; the eval logits of the start weights on the "auto" run's
    last batch; two runs of one more step from one state (bit-identical:
    loss, gradients, weights, statistics, momentum); a profile of one more
    step (device ms, busy share against the run's median step, device
    ops); and, where the method runs them, every K1-K4 and K6 call of one
    recorded step against its plain version (``cli_kernels_f32``,
    ``k6_calls``). Fails unless every method's step-1 loss is within
    METHOD_TOL (relative) of "auto"'s, its eval logits within METHOD_TOL x
    max|logit| of "auto"'s, its repeats bit-identical, its convs took its
    route, and under "window" K2 and K3 launched."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.co3d_3d import train as cli
    from nerf_downstream_tpu_torch.models.mink.layers import (
        SparseConv,
        SparseConvTranspose,
    )
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train import checkpoints

    start = os.path.join(kept["save"], "best.ckpt")
    weights = checkpoints.load_checkpoint(start)
    tmp = tempfile.mkdtemp(prefix="cli_methods_")
    line = {"phase": "cli_methods", "card": card,
            "entry": "python -m nerf_downstream_tpu_torch.co3d_3d.train",
            "start": "cli_train's best.ckpt", "steps": METHOD_STEPS,
            "bindings": {m: list(b) for m, b in METHOD_BINDINGS.items()},
            "tolerance": METHOD_TOL, "dtype": "float32"}
    total = dict.fromkeys(kernels.launch_counts(), 0)
    ref = None
    try:
        for method in ("auto",) + METHODS:
            args = list(kept["args"])
            for b in (*METHOD_BINDINGS[method],
                      f"train.max_steps = {METHOD_STEPS}",
                      f'train.checkpoint_path = "{start}"',
                      "train.load_weights = True",
                      "train.val_every_n_steps = 1000",
                      "train.evaluate = False", *bindings):
                args += ["--ginb", b]
            args += ["--save_path", os.path.join(tmp, method), "--seed", "0",
                     "--device", device]
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with CliProbe() as probe, \
                    contextlib.redirect_stdout(io.StringIO()):
                gin.clear_config()
                t0 = time.perf_counter()
                cli.main(args)
                run_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            for k, v in counts.items():
                total[k] += v
            task, state, batch = probe.last
            model = task.model
            routes = sorted({m.route for m in model.modules()
                             if isinstance(m, (SparseConv,
                                               SparseConvTranspose))
                             and m.route})
            ms = [m for _, m in probe.steps]
            rec_line = {"losses": probe.losses, "ms": ms,
                        "ms_median_after_first": float(np.median(ms[1:])),
                        "run_seconds": run_s, "routes": routes,
                        "launches": counts}
            # the start weights' eval logits on one batch for every method
            eval_batch = batch if ref is None else ref["batch"]
            trained = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(convert.flax_to_state_dict(model, {
                "params": weights["params"],
                "batch_stats": weights["batch_stats"]}))
            model.eval()
            with torch.no_grad():
                logits = model(task.model_input(eval_batch)).float()
            model.train()
            model.load_state_dict(trained)
            logits = logits[eval_batch["mask"]]
            if not bool(torch.isfinite(logits).all()):
                raise PhaseError(f"cli_methods: {method}: non-finite eval "
                                 "logits")
            if ref is None:
                ref = {"batch": batch, "logits": logits,
                       "loss": probe.losses[0]}
            rec_line["step1_loss_rel_gap"] = (
                abs(probe.losses[0] - ref["loss"]) / abs(ref["loss"]))
            rec_line["eval_gap_of_max"] = float(
                (logits - ref["logits"]).abs().max()
                / ref["logits"].abs().max())
            rec_line["repeat_identical"] = repeat_identical(task, state,
                                                            batch)
            state, wall, dev_ms, ops = profiled_step(
                f"cli_methods/{method}", task, state, batch)
            rec_line["profile"] = {
                "wall_ms_per_step_profiled": wall,
                "device_ms_per_step": dev_ms,
                "device_busy_share": dev_ms / rec_line[
                    "ms_median_after_first"],
                "device_ops_per_step": ops}
            if method in ("window", "block"):
                with ClsStepRecorder() as rec:
                    task.train_step(state, batch)
                where = f"cli_methods/{method}"
                if method == "window":
                    rec_line["kernels_per_step"] = cli_kernels_f32(rec,
                                                                   where)
                rec_line["row_gather_matmul"] = k6_summary(
                    k6_calls(where, rec.k6), len(rec.k6))
                del rec
            line[method] = rec_line
            ok = (np.isfinite(probe.losses).all()
                  and len(probe.losses) == METHOD_STEPS
                  and rec_line["step1_loss_rel_gap"] <= METHOD_TOL
                  and rec_line["eval_gap_of_max"] <= METHOD_TOL
                  and all(rec_line["repeat_identical"].values())
                  and METHOD_ROUTE[method] in routes
                  and (method != "window"
                       or (counts["window_gather_matmul"] > 0
                           and counts["window_bwd"] > 0)))
            if not ok:
                raise PhaseError(f"cli_methods: {method}: {rec_line}")
            del task, state, batch, model, probe
        line["launches"] = total
        return line, total
    finally:
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)


# phase cli_kitti: the flagship CLI on SemanticKITTI scans of HDL-64E size
KITTI_SCANS = {"00": 6, "08": 1}  # frames per sequence (00 trains, 08 validates)
KITTI_STEPS = 3
KITTI_TOL = 1e-4  # of max|logit|: one scan's eval logits, card against CPU
KITTI_KERNELS = ("window_starts", "window_match", "window_gather_matmul",
                 "window_bwd", "window_dw")
# The flagship config turned to SemanticKITTI: its reader and classes,
# "hybrid" without a grid extent (the fully-windowed path on packed keys
# alone, the reference's outdoor setting), and what these scans need, as
# measured on the CPU: no level caps (at 0.05 m a scan's rows thin about
# 2x per stride doubling, 183,225 / 97,040 / 41,819 / 15,448 / 5,402 for
# two scans, not the 4x the config's level_cap_decay 0.5 assumes of
# shells; on small scans the caps poison in both packages), and
# window_size 512 (at the config's 128 the stride-1 plan of two scans
# needs 11,983 escape entries in 80 tiles, past its 8,192 and 64; at 512,
# 1,934 in 9).
KITTI_BINDINGS = (
    'get_dataset.dataset_name = "SemanticKITTIDataset"',
    "SemanticKITTIDataset.ignore_label = -255",
    "get_model.in_channel = 4", "get_model.out_channel = 19",
    'CoordinateContext.method = "hybrid"',
    "CoordinateContext.grid_extent = None",
    "CoordinateContext.level_cap_decay = None",
    "CoordinateContext.window_size = 512",
    "train.device_transforms = []",
    "train.batch_size = 2", "train.val_batch_size = 1",
    f"train.max_steps = {KITTI_STEPS}",
    # the Trainer validates after step indices that the cadence divides:
    # one validation, after the last step
    f"train.val_every_n_steps = {KITTI_STEPS - 1}",
    "train.log_every_n_steps = 1", 'train.loggers = ["jsonl"]',
)


def phase_cli_kitti(card: str, device: str = "cuda",
                    bindings=()) -> tuple[dict, dict]:
    """``co3d_3d.train`` on ``scannet_plenoxel.gin`` with
    ``KITTI_BINDINGS`` (Res16UNet at full width, in_channel 4 (xyzi), 19
    classes, batch 2, voxel 0.05 m, f32) over SemanticKITTI scans the port
    writes in the benchmark's layout (``data.synthetic.write_kitti_tree``:
    64 beams x 2,048 azimuths = 131,072 points each; ground, building
    fronts and boxes out to 80 m; raw labels with moving classes):
    ``KITTI_STEPS`` steps and one validation on sequence 08, launch counts
    reset before and read after. Then two runs of one more step
    (bit-identical), a profile of one step, every K1-K4 call of a recorded
    step against its plain version (``cli_kernels_f32``; K6 is not on
    this route: every conv of Res16UNet rides window plans), one eval
    forward of the 08 scan on the card against the CPU's on the row path
    ("search", the same function summed in another order) within
    KITTI_TOL x max|logit|, and ``save_prediction`` of its argmax: a
    uint32 label file of the scan's length in the reference's layout,
    holding raw ids only. Fails on a non-finite loss (the Trainer
    raises), a validation without mIoU, a kernel of KITTI_KERNELS never
    launched, or any of those checks."""
    import contextlib
    import copy
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.co3d_3d import train as cli
    from nerf_downstream_tpu_torch.data.semantic_kitti import (
        LABEL_NAME_MAPPING,
        SemanticKITTIDataset,
    )
    from nerf_downstream_tpu_torch.data.synthetic import write_kitti_tree
    from nerf_downstream_tpu_torch.data.utils import collate_mink
    from nerf_downstream_tpu_torch.models.mink.layers import (
        SparseConv,
        SparseConvTranspose,
    )
    from nerf_downstream_tpu_torch.ops import kernels

    tmp = tempfile.mkdtemp(prefix="cli_kitti_")
    try:
        t0 = time.perf_counter()
        root = write_kitti_tree(os.path.join(tmp, "kitti"),
                                np.random.default_rng(0), KITTI_SCANS)
        tree_s = time.perf_counter() - t0
        save = os.path.join(tmp, "exp")
        config = os.path.join(REPO, "co3d_3d", "configs",
                              "scannet_plenoxel.gin")
        args = ["--ginc", config]
        for b in (*KITTI_BINDINGS,
                  f'SemanticKITTIDataset.data_root = "{root}"', *bindings):
            args += ["--ginb", b]
        args += ["--save_path", save, "--seed", "0", "--device", device]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with CliProbe() as probe, contextlib.redirect_stdout(io.StringIO()):
            gin.clear_config()
            t0 = time.perf_counter()
            cli.main(args)
            run_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        task, state, batch = probe.last
        model = task.model
        run = os.path.join(save, f"b2x1-{type(model).__name__}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logged = [json.loads(ln) for ln in f]
        val = [{k: r[k] for k in ("step", "val/loss", "val/mIoU")}
               for r in logged if "val/mIoU" in r]
        routes = sorted({m.route for m in model.modules()
                         if isinstance(m, (SparseConv, SparseConvTranspose))
                         and m.route})
        ms = [m for _, m in probe.steps]
        line = {"phase": "cli_kitti", "card": card,
                "entry": "python -m nerf_downstream_tpu_torch.co3d_3d.train",
                "config": "co3d_3d/configs/scannet_plenoxel.gin",
                "bindings": list(KITTI_BINDINGS),
                "scans": dict(KITTI_SCANS, points_each=64 * 2048,
                              seconds=tree_s),
                "dtype": "float32", "capacity": int(batch["mask"].shape[0]),
                "valid_points": probe.rows, "losses": probe.losses,
                "ms": ms, "ms_median_after_first": float(np.median(ms[1:])),
                "run_seconds": run_s, "val": val,
                "val_pass_ms": probe.val_ms, "routes": routes,
                "launches": counts}
        ok = (np.isfinite(probe.losses).all()
              and len(probe.losses) == KITTI_STEPS and len(val) == 1
              and np.isfinite(val[0]["val/loss"])
              and routes == ["windowed"]
              and all(counts[k] > 0 for k in KITTI_KERNELS))
        if not ok:
            raise PhaseError(f"cli_kitti: {line}")
        line["repeat_identical"] = repeat_identical(task, state, batch)
        state, wall, dev_ms, ops = profiled_step("cli_kitti", task, state,
                                                 batch)
        line["profile"] = {"wall_ms_per_step_profiled": wall,
                           "device_ms_per_step": dev_ms,
                           "device_busy_share":
                               dev_ms / line["ms_median_after_first"],
                           "device_ops_per_step": ops}
        with CliStepRecorder() as rec:
            task.train_step(state, batch)
        line["kernels_per_step"] = cli_kernels_f32(rec, "cli_kitti",
                                                   scaled_dw=True)
        del rec

        # one scan of sequence 08: card (windowed) against CPU (row path)
        ds = SemanticKITTIDataset("val", data_root=root)
        item = ds[0]
        one = collate_mink([item], grid_extent=None)
        one_t = {k: torch.as_tensor(v) for k, v in one.items()
                 if isinstance(v, np.ndarray)}
        model.eval()
        with torch.no_grad():
            card_logits = model(task.model_input(
                {k: v.to(device) for k, v in one_t.items()})).float().cpu()
            cpu_model = copy.deepcopy(model).to("cpu")
            cpu_model.ctx_kwargs = dict(cpu_model.ctx_kwargs,
                                        method="search")
            t0 = time.perf_counter()
            cpu_logits = cpu_model(task.model_input(one_t)).float()
            cpu_s = time.perf_counter() - t0
        model.train()
        m = one_t["mask"]
        gap = float((card_logits[m] - cpu_logits[m]).abs().max()
                    / cpu_logits[m].abs().max())
        pred = card_logits[m].argmax(1).numpy()
        pred_file = ds.save_prediction(pred, os.path.join(tmp, "pred"),
                                       item["metadata"])
        written = np.fromfile(pred_file, dtype=np.uint32)
        line["eval_one_scan"] = {
            "points": int(m.sum()), "gap_of_max": gap, "cpu_seconds": cpu_s,
            "cpu_route": "search", "prediction_file":
                os.path.relpath(pred_file, tmp),
            "prediction_labels": len(written),
            "raw_ids_only": bool(np.isin(written, list(LABEL_NAME_MAPPING))
                                 .all())}
        if not (gap <= KITTI_TOL and len(written) == int(m.sum())
                and line["eval_one_scan"]["raw_ids_only"]
                and all(line["repeat_identical"].values())):
            raise PhaseError(f"cli_kitti: {line}")
        return line, counts
    finally:
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)


CLS_TREE = dict(n_train=32, n_val=8, n_voxels=10_000, reso=(128, 128, 128),
                num_classes=51)
CLS_STEPS, CLS_RESUME_STEPS, CLS_VAL_EVERY = 6, 8, 5
CLS_BATCH = 16
CLS_KERNELS = ("window_starts", "window_match", "window_gather_matmul",
               "window_bwd", "row_gather_matmul")
CLS_CONFIGS = ("co3d_cls.gin", "co3d_aug3.gin", "feature_sh.gin",
               "resnet14.gin")


class ClsStepRecorder(CliStepRecorder):
    """Records what ``CliStepRecorder`` records, and the inputs of every
    K6 call of the step (the row path's forward)."""

    def __enter__(self):
        from nerf_downstream_tpu_torch.ops import sparse_conv

        super().__enter__()
        self.k6 = []
        self._rg = sparse_conv.row_gather_matmul
        rg = self._rg

        def rec_rg(x_ext, km, w):
            self.k6.append((x_ext.detach().clone(), km.clone(),
                            w.detach().clone()))
            return rg(x_ext, km, w)

        sparse_conv.row_gather_matmul = rec_rg
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.ops import sparse_conv

        sparse_conv.row_gather_matmul = self._rg
        return super().__exit__(*exc)


def as_bf16(args):
    """Floating tensors of ``args`` rounded to bf16, the rest as they are."""
    import torch

    return [a.to(torch.bfloat16) if torch.is_tensor(a)
            and a.is_floating_point() else a for a in args]


def up(args):
    """Floating tensors of ``args`` in f32, the rest as they are."""
    import torch

    return [a.float() if torch.is_tensor(a) and a.is_floating_point()
            else a for a in args]


def k6_calls(where: str, calls, types=("f32",)) -> list[dict]:
    """Every recorded K6 call ``(x_ext, km, w)`` against its plain
    version on the same inputs, in each of ``types`` ("f32": the inputs as
    recorded, within ``k6_bad``'s 1e-5 x (1 + the sum of absolute
    products) of the f32 sum; "bf16": the inputs rounded to bf16, rtol
    2^-8 with atol 1e-5 x max of the f32 sum on those values), each with
    two launches bit-identical; per call its shape, real pairs, core and
    step split, device ms beside its bound and roofline share, the plain
    version's ms and, for information, an im2col plus one
    ``torch.matmul``. Fails on an empty, non-finite or all-zero record."""
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        row_gather_matmul,
        row_gather_matmul_plain,
        tc,
    )

    if not calls:
        raise PhaseError(f"{where}: the step made no K6 call")
    _finite_nonzero(where, "K6", [a[0] for a in calls])
    out = []
    for x, km, w in calls:
        k, n_out = km.shape
        c, cout = w.shape[-2:]
        row = {"K": k, "n_in": x.shape[0] - 1, "n_out": n_out, "C": c,
               "Cout": cout, "pairs": int((km < x.shape[0] - 1).sum())}
        for name in types:
            args = [x, km, w] if name == "f32" else as_bf16([x, km, w])
            want = row_gather_matmul_plain(*up(args))
            got = row_gather_matmul(*args)
            bad = (k6_bad(*args, got, want) if name == "f32"
                   else dfeats_bad(got, want, torch.bfloat16))
            if bad:
                raise PhaseError(f"{where}: K6 ({name}) outside tolerance: "
                                 f"{bad} elements at {row}")
            if not torch.equal(row_gather_matmul(*args), got):
                raise PhaseError(f"{where}: K6 ({name}) repeats differ")
            choice = tc.row_choice(args[0].dtype, n_out, c, cout, k,
                                   tc.aligned(args[0], args[2]))
            b, by = bound(*k6_work(*args), args[0].dtype)
            t = device_ms(lambda: row_gather_matmul(*args))
            row[name] = {"max_abs_err": float((got - want).abs().max()),
                         "core": choice.describe_steps(), "ms": t,
                         "bound_ms": b, "bound_by": by,
                         "roofline_share": b / t}
        row["plain_ms"] = device_ms(lambda: row_gather_matmul_plain(x, km, w),
                                    reps=2)
        cols = km.t().long().contiguous()
        wm = w.reshape(k * c, cout)
        row["im2col_matmul_ms"] = device_ms(lambda: torch.matmul(
            x[cols].reshape(n_out, k * c), wm), reps=2)
        out.append(row)
    return out


def k6_summary(calls: list[dict], launches_per_step: int) -> dict:
    """One step's K6 calls (``k6_calls`` rows) summed in f32: ms, bound,
    plain ms, the largest error and the shapes."""
    return {"launches_per_step": launches_per_step,
            "shapes": [(r["C"], r["Cout"], r["n_out"]) for r in calls],
            **{k: sum(r["f32"][k] for r in calls)
               for k in ("ms", "bound_ms")},
            "plain_ms": sum(r["plain_ms"] for r in calls),
            "max_abs_err": max(r["f32"]["max_abs_err"] for r in calls)}


def cli_cls_kernels(rec, wide: int = 512) -> dict:
    """The classification step's kernels on the row path and at 512
    channels, each call held against its plain version on the step's own
    inputs, in f32 and at the same shapes in bf16 (inputs rounded to bf16,
    the plain version on those values in f32):

    - every K6 call (the four k3/s2 convs), as ``k6_calls`` holds them,
      in f32 and bf16;
    - every K2 call and every K3 call with ``wide`` (512, the widest
      stage) input or output channels: K2 and K3's d_feats as K6, K3's
      d_w within 1e-5 of each (g, m)'s largest; per call ms in both
      types, plain ms and the bound."""
    from nerf_downstream_tpu_torch.ops.kernels import (
        tc,
        window_bwd,
        window_bwd_plain,
        window_gather_matmul,
        window_gather_matmul_plain,
    )

    where = "cli_cls"
    k6 = k6_calls(where, rec.k6, ("f32", "bf16"))

    k2 = []
    wide2 = [a for a in rec.k2 if wide in a[3].shape[-2:]]
    if not wide2:
        raise PhaseError(f"{where}: no K2 call at {wide} channels")
    _finite_nonzero(where, f"K2 ({wide})", [a[0] for a in wide2])
    for feats, starts, idx, w in wide2:
        g, nt, m, tile = idx.shape
        row = {"C": w.shape[-2], "Cout": w.shape[-1], "G": g, "M": m,
               "tile": tile, "n_in": feats.shape[0], "n_out": nt * tile}
        for name, args in (("f32", [feats, starts, idx, w]),
                           ("bf16", as_bf16([feats, starts, idx, w]))):
            want = window_gather_matmul_plain(*up(args))
            got = window_gather_matmul(*args)
            if dfeats_bad(got, want, args[0].dtype):
                raise PhaseError(f"{where}: K2 ({name}) outside tolerance "
                                 f"at {row}")
            b, by = bound(*k2_work(*args), args[0].dtype)
            t = device_ms(lambda: window_gather_matmul(*args))
            row[name] = {"max_abs_err": float((got.float() - want).abs()
                                              .max()),
                         "core": tc.gather_choice(
                             args[0].dtype, nt * tile, row["C"],
                             row["Cout"], g * m).describe(),
                         "ms": t, "bound_ms": b, "bound_by": by,
                         "roofline_share": b / t}
        row["plain_ms"] = device_ms(
            lambda: window_gather_matmul_plain(feats, starts, idx, w), reps=2)
        k2.append(row)

    k3 = []
    wide3 = [c3 for c3 in rec.k3
             if wide in (c3["feats"].shape[1], c3["g_out"].shape[1])]
    if not wide3:
        raise PhaseError(f"{where}: no K3 call at {wide} channels")
    _finite_nonzero(where, f"K3 ({wide})", [c3["g_out"] for c3 in wide3])
    for c3 in wide3:
        args32 = [c3[k] for k in ("g_out", "feats", "inv_starts", "inv_idx",
                                  "w_t")]
        g, nt, m, tile = c3["inv_idx"].shape
        row = {"C": c3["feats"].shape[1], "Cout": c3["g_out"].shape[1],
               "G": g, "M": m, "tile": tile, "n_in": nt * tile,
               "n_out": c3["g_out"].shape[0]}
        for name, args in (("f32", args32), ("bf16", as_bf16(args32))):
            want_f, want_w = window_bwd_plain(*up(args))
            got_f, got_w = window_bwd(*args)
            rel, _ = dw_err(got_w, want_w)
            if dfeats_bad(got_f, want_f, args[0].dtype) or not rel <= DW_TOL:
                raise PhaseError(f"{where}: K3 ({name}) outside tolerance "
                                 f"at {row}: d_w {rel:.3g} of its largest")
            cc = dict(c3, g_out=args[0], feats=args[1], w_t=args[4])
            b, by = bound(*k3_work(cc), args[0].dtype)
            t = device_ms(lambda: window_bwd(*args))
            row[name] = {"max_abs_err_d_feats": float(
                             (got_f.float() - want_f).abs().max()),
                         "d_w_worst_of_max": rel,
                         "ms": t, "bound_ms": b, "bound_by": by,
                         "roofline_share": b / t}
        row["plain_ms"] = device_ms(lambda: window_bwd_plain(*args32),
                                    reps=2)
        k3.append(row)
    return {"row_gather_matmul": k6, "wide_channels": wide,
            "window_gather_matmul_wide": k2, "window_bwd_wide": k3,
            "tolerance": {"k6_f32": f"{K2_F32_TOL} x (1 + sum |x| |w|)",
                          "bf16_d_feats": DFEATS_TOL["bfloat16"],
                          "d_w_of_max": DW_TOL}}


def phase_cli_cls(card: str, device: str = "cuda", bindings=(),
                  keep: dict | None = None) -> tuple[dict, dict]:
    """The README's classification command through the port's training
    CLI, at full width (ResNet14 on ``co3d_cls.gin`` + ``co3d_aug3.gin``
    + ``feature_sh.gin`` + ``resnet14.gin``: batch 16, val batch 8, SGD
    with momentum 0.9, cosine lr, f32) on a synthetic PeRFception-CO3D
    tree the port writes (``CLS_TREE``: 32 train and 8 val shells of
    10,000 voxels at 128^3). The CLI auto-calibrates its capacity knobs
    on the card (timed), runs ``CLS_STEPS`` steps with one validation
    pass, then ``--resume`` to ``CLS_RESUME_STEPS`` with the knobs
    pinned.
    Launch counts are reset just before the first run and read just after
    the second. Fails unless: every loss is finite, ``val/acc1`` is
    logged, the checkpoints and logs exist, the resumed run starts at
    step ``CLS_STEPS`` from the checkpoint's momentum buffers bit for
    bit, every conv computes in f32, and K1, the pass, K2, K3 and K6 each
    launched. Then one more step is profiled and its synchronising calls
    counted, and its K1-K3 calls are held against their plain versions in
    f32 (``cli_kernels_f32``) and its K6 calls and its K2 and K3 calls at
    512 channels in f32 and bf16 (``cli_cls_kernels``). ``device`` and
    ``bindings`` serve a rehearsal on the CPU at a narrow width; ``keep``
    as in ``phase_cli_train`` (with the pinned knobs)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.co3d_3d import train as cli
    from nerf_downstream_tpu_torch.data.synthetic import write_co3d_tree
    from nerf_downstream_tpu_torch.models.mink.layers import SparseConv
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train import checkpoints
    from nerf_downstream_tpu_torch.utils import calibrate as calib

    tmp = tempfile.mkdtemp(prefix="cli_cls_")
    calibrations = []  # every calibrate() of the automatic calibration
    measure, scan = calib.calibrate, calib.maybe_auto_calibrate

    def timed_calibrate(batches, **kw):
        batches = list(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        knobs = measure(batches, **kw)
        torch.cuda.synchronize()
        calibrations.append({
            "seconds": time.perf_counter() - t0, "knobs": knobs,
            "batches": len(batches), "capacities": sorted({
                int(b["coordinates"].shape[0]) for b in batches}),
            "valid_rows": [int(np.asarray(b["mask"]).sum())
                           for b in batches]})
        return knobs

    scans = []  # each automatic calibration: seconds, knobs bound?

    def timed_scan(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scan(*a, **kw)
        torch.cuda.synchronize()
        scans.append({"seconds": time.perf_counter() - t0, "bound": out})
        return out

    try:
        t0 = time.perf_counter()
        data_root, _ = write_co3d_tree(tmp, np.random.default_rng(0),
                                       **CLS_TREE)
        tree_s = time.perf_counter() - t0
        save = os.path.join(tmp, "exp")
        args = [a for c in CLS_CONFIGS for a in (
            "--ginc", os.path.join(REPO, "co3d_3d", "configs", c))]
        for b in (f'Co3DDatasetBase.data_root = "{data_root}"',
                  f"train.val_every_n_steps = {CLS_VAL_EVERY}",
                  "train.log_every_n_steps = 1",
                  'train.loggers = ["csv", "jsonl"]', *bindings):
            args += ["--ginb", b]
        base = list(args)
        args += ["--save_path", save, "--seed", "777", "--device", device]
        stdout = io.StringIO()
        calib.calibrate, calib.maybe_auto_calibrate = (timed_calibrate,
                                                       timed_scan)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with CliProbe("ClassificationTraining") as probe, \
                contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            gin.clear_config()
            cli.main(args + ["--ginb", f"train.max_steps = {CLS_STEPS}"])
            first_s = time.perf_counter() - t0
            last = checkpoints.load_checkpoint(os.path.join(save,
                                                            "last.ckpt"))
            inner = last["opt_state"]["1"]
            probe.resume_trace = convert.flax_to_state_dict(
                probe.last[0].model, inner["0"]["trace"])
            # the resume pins the first run's knobs, as a user pins them
            # with co3d_3d.calibrate (same shapes; no second scan)
            pinned = [a for k, v in calibrations[-1]["knobs"].items()
                      for a in ("--ginb", f"CoordinateContext.{k} = {v!r}")]
            t0 = time.perf_counter()
            gin.clear_config()
            cli.main(args + pinned + ["--ginb", f"train.max_steps = "
                                                f"{CLS_RESUME_STEPS}",
                                      "--resume"])
            resume_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        calib.calibrate, calib.maybe_auto_calibrate = measure, scan
        task, state, batch = probe.last
        run = os.path.join(save, f"b{CLS_BATCH}x1-MinkResNetBase")
        files = {name: os.path.exists(os.path.join(d, name)) for d, name in (
            (save, "last.ckpt"), (save, "best.ckpt"),
            (run, "metrics.csv"), (run, "metrics.jsonl"))}
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logged = [json.loads(ln) for ln in f]
        train_losses = [r["train/loss"] for r in logged if "train/loss" in r]
        val = [{k: r[k] for k in ("step", "val/loss", "val/acc1",
                                  "val/acc5")}
               for r in logged if "val/acc1" in r]
        best = checkpoints.load_checkpoint(os.path.join(save, "best.ckpt"))
        types = {m.compute_dtype for m in task.model.modules()
                 if isinstance(m, SparseConv)}
        steps = [s for s, _ in probe.steps]
        ms = [m for _, m in probe.steps]
        prof = probe.profilers[-1]
        capacity = int(batch["mask"].shape[0])
        line = {
            "phase": "cli_cls", "card": card, "entry":
            "python -m nerf_downstream_tpu_torch.co3d_3d.train",
            "configs": [f"co3d_3d/configs/{c}" for c in CLS_CONFIGS],
            "model": type(task.model).__name__,
            "planes": list(task.model.planes),
            "tree": dict(CLS_TREE, seconds=tree_s),
            "dtype": "float32 (the configs bind no compute type; every "
                     "conv on the CUDA cores)",
            "batch": CLS_BATCH, "capacity": capacity,
            "valid_finest_rows": probe.rows,
            "automatic_calibration": scans, "calibrations": calibrations,
            "steps": steps, "ms": ms,
            "ms_median_after_first": float(np.median(ms[1:])),
            "run_seconds": [first_s, resume_s],
            "train_losses": train_losses, "val": val,
            "val_pass_ms": probe.val_ms,
            "host_ms_per_batch_waited": prof.recorded_time(
                "get_train_batch") * 1e3,
            "best_ckpt_step": best["global_step"],
            "resume": probe.resume_check, "files": files,
            "launches": counts,
        }
        ok = (all(files.values())
              and [c["bound"] for c in scans] == [True, False]
              and len(calibrations) >= 1
              and np.isfinite(train_losses).all() and len(train_losses) > 0
              and len(val) == 1
              and all(np.isfinite(v["val/loss"])
                      and 0 <= v["val/acc1"] <= 100 for v in val)
              and steps == list(range(CLS_RESUME_STEPS))
              and probe.resume_check == {"step": CLS_STEPS,
                                         "momentum_bit_equal": True}
              and types == {torch.float32}
              and all(counts[k] > 0 for k in CLS_KERNELS))
        if not ok:
            raise PhaseError(f"cli_cls: {line}")

        # one more step of the same task
        from nerf_downstream_tpu_torch.data.data_module import DataModule

        dm = DataModule(batch_size=CLS_BATCH, val_batch_size=8,
                        train_num_workers=1, capacity=capacity)
        rec = cli_extra_steps("cli_cls", line, task, state, batch, dm,
                              ClsStepRecorder, 2)
        line["k6_per_step"] = len(rec.k6)
        line["kernels_per_step"] = cli_kernels_f32(rec, "cli_cls")
        line["row_path_and_512"] = cli_cls_kernels(
            rec, max(task.model.planes))
        if keep is not None:
            keep.update(tmp=tmp, args=base + pinned, save=save, val=val,
                        val_batch_size=8, data_root=data_root,
                        fdir=os.path.join(data_root, "filelist"),
                        knobs=calibrations[-1]["knobs"], capacity=capacity)
        return line, counts
    finally:
        calib.calibrate, calib.maybe_auto_calibrate = measure, scan
        gin.clear_config()
        if keep is None or "tmp" not in keep:
            shutil.rmtree(tmp, ignore_errors=True)


# -- the fused 2D+3D ensemble, the optimizers, the training surface ----------

# phase ensemble: Ensemble2D3D at full width on cli_cls's tree (one frame
# per scene) with cli_cls's knobs and capacity: "logit" then "feature"
ENS_STEPS = {"logit": 5, "feature": 2}
ENS_IMAGE = 224
ENS_FRAME = (256, 256)  # the frames' size on disk (w, h), resized to ENS_IMAGE
ENS_CPU_SCENES = 4  # scenes of the card-against-CPU eval batch
ENS_CPU_CAPACITY = 65_536
ENS_KERNELS = ("window_starts", "window_match", "window_gather_matmul",
               "window_bwd", "row_gather_matmul")
# the port's own kernels (ops/kernels/*.cu), by function name
CUSTOM_KERNELS = ("window_starts_kernel", "window_match_kernel",
                  "gather_matmul_kernel", "gather_mma_kernel",
                  "split_reduce_kernel", "window_dw_kernel",
                  "dw_mma_kernel", "dw_reduce_kernel")
OPT_STEPS = 3
OPT_LR = 1e-3  # every optimizer's (Rprop's initial step size)
OPT_TOL = 1e-5  # of max|update|: the card's optimizer step against the CPU's
OPT_ULPS = 2.0 ** -22  # x |p|: two f32 roundings of the final add p + u
SURFACE_STEPS, SURFACE_RESUME_STEPS = 3, 4
SURFACE_HOST_BATCHES = 4  # timed batches per worker kind, after a first
SURFACE_BINDINGS = ('train.optimizer_name = "AdamW"', "train.lr = 0.001",
                    'train.loggers = ["csv", "tensorboard"]',
                    'DataModule.worker_mode = "process"',
                    "train.load_weights = True",
                    "train.transfer_self_supervised = True",
                    "train.val_every_n_steps = 2",
                    "train.log_every_n_steps = 1")


def cls_bindings(kept_cls: dict) -> list[str]:
    """The bindings that put cli_cls's tree and pinned knobs
    (``kept["cli_cls"]``) on top of its configs."""
    return [f'Co3DDatasetBase.data_root = "{kept_cls["data_root"]}"',
            *(f"CoordinateContext.{k} = {v!r}"
              for k, v in kept_cls["knobs"].items())]


def parse_cls_config(kept_cls: dict, extra=()) -> None:
    """cli_cls's configs, tree and knobs, and ``extra`` bindings, as the
    only gin configuration."""
    from nerf_downstream_tpu_torch import config as gin

    gin.clear_config()
    gin.parse_config_files_and_bindings(
        [os.path.join(REPO, "co3d_3d", "configs", c) for c in CLS_CONFIGS],
        cls_bindings(kept_cls) + list(extra))


def joint_batches(ds, capacity: int, size: int, n: int) -> list[dict]:
    """``n`` collated joint batches of ``size`` scenes each, in order
    through ``ds`` (numpy)."""
    from nerf_downstream_tpu_torch.data.joint import collate_joint

    out = []
    for b in range(n):
        idx = [(b * size + i) % len(ds) for i in range(size)]
        batch = collate_joint([ds[i] for i in idx], capacity=capacity)
        batch.pop("metadata", None)
        out.append(batch)
    return out


def ensemble_model(fusion: str, in_channels: int, seed: int, device):
    import torch

    from nerf_downstream_tpu_torch.models.ensemble import Ensemble2D3D
    from nerf_downstream_tpu_torch.train.modules import init_variables

    model = Ensemble2D3D(in_channels=in_channels, out_channel=51,
                         image_model="resnet18", voxel_model="ResNet14",
                         num_batches=CLS_BATCH, fusion=fusion,
                         compute_dtype=torch.float32)
    return init_variables(model, seed).to(device)


def timed_steps(task, state, batches, n: int):
    """``n`` training steps over ``batches`` in turn, each between two
    synchronises: (state, losses, ms)."""
    import torch

    losses, ms = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mets = task.train_step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(mets["loss"]))
    return state, losses, ms


def fresh_state_from(path: str, task_cls, model, **task_kw):
    """A new task and state over ``model`` with the training state of the
    checkpoint at ``path`` restored (weights, optimizer, step)."""
    from nerf_downstream_tpu_torch.train import checkpoints

    task = task_cls(model, **task_kw)
    state = task.create_state()
    raw = checkpoints.load_checkpoint(path)
    checkpoints.restore_into(state, raw, weights=True, optimizer=True)
    state.step = int(raw["global_step"])
    return task, state


def bit_equal_after(task_a, state_a, task_b, state_b, batch) -> dict:
    """One step of each (task, state) on ``batch``: whether the losses and
    every weight and statistic after are bit-equal."""
    import torch

    _, ma = task_a.train_step(state_a, batch)
    _, mb = task_b.train_step(state_b, batch)
    sa, sb = state_a.model.state_dict(), state_b.model.state_dict()
    return {"loss": bool(torch.equal(ma["loss"], mb["loss"])),
            "state": all(torch.equal(sa[k], sb[k]) for k in sa)}


def phase_ensemble(card: str, kept_cls: dict,
                   device: str = "cuda") -> tuple[dict, dict, tuple]:
    """The fused 2D+3D classifier through the task API at full width:
    ``Ensemble2D3D(out_channel=51, "resnet18", "ResNet14")``, batch
    ``CLS_BATCH`` (16) of ``ENS_IMAGE`` (224) frames and cli_cls's scenes
    (its tree, configs, pinned knobs and capacity, ``kept["cli_cls"]``;
    one synthetic frame per scene written beside it), f32, SGD with
    ``co3d_cls.gin``'s momentum, lr and weight decay, no schedule:
    ``ENS_STEPS`` steps with "logit" fusion, then with "feature". Launch
    counts are reset just before the steps and read just after. Fails
    unless every loss is finite, two runs of one step are bit-identical,
    both branches' leaves (and the fusion weight) moved, a training state
    saved and restored gives a bit-equal next step, K1, the pass, K2, K3
    and K6 each launched, the eval logits on the card are within
    ``EXTRA_TOL`` x max|logit| of the CPU's on ``ENS_CPU_SCENES`` scenes,
    and every K1, pass, K2, K3 call (``cli_kernels_f32``) and K6 call
    (``k6_calls``) of one recorded step agrees with its plain version.
    Also: the steps' median ms, one profiled step (device ms, busy share,
    device ops, the port's kernels' device ms) and the 2D branch's
    forward and backward device ms. Returns (line, launch counts, (task,
    state, batches)) for phase optimizers."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.data.joint import (
        JointCo3DDataset,
        collate_joint,
    )
    from nerf_downstream_tpu_torch.data.synthetic import write_co3d_frames
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train import checkpoints
    from nerf_downstream_tpu_torch.train.loop import to_device
    from nerf_downstream_tpu_torch.train.modules import (
        EnsembleClassificationTraining,
    )

    where = "ensemble"
    tmp = tempfile.mkdtemp(prefix="ensemble_")
    try:
        parse_cls_config(kept_cls)
        t0 = time.perf_counter()
        frames = write_co3d_frames(os.path.join(tmp, "frames"),
                                   np.random.default_rng(1),
                                   kept_cls["fdir"], ENS_FRAME)
        ds = JointCo3DDataset("train", data_root=kept_cls["data_root"],
                              frames_root=frames, image_size=ENS_IMAGE)
        cap = kept_cls["capacity"]
        host = joint_batches(ds, cap, CLS_BATCH, 2)
        data_s = time.perf_counter() - t0
        batches = [to_device(b, device) for b in host]
        c_in = host[0]["features"].shape[1]
        hyper = dict(optimizer_name="SGD", scheduler_name="none",
                     lr=gin.query_parameter("train.lr"),
                     weight_decay=gin.query_parameter("train.weight_decay"))
        line = {"phase": where, "card": card,
                "entry": "nerf_downstream_tpu_torch.train.modules."
                         "EnsembleClassificationTraining (task API)",
                "model": "Ensemble2D3D(out_channel=51, resnet18, ResNet14)",
                "batch": CLS_BATCH, "image": ENS_IMAGE, "capacity": cap,
                "valid_rows": [int(b["mask"].sum()) for b in host],
                "dtype": "float32 (TF32 off, deterministic cuDNN)",
                "optimizer": dict(hyper, momentum=gin.query_parameter(
                    "SGD.momentum")), "data_seconds": data_s}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        runs = {}
        for fusion, n in ENS_STEPS.items():
            model = ensemble_model(fusion, c_in, 5, device)
            task = EnsembleClassificationTraining(model, **hyper)
            state = task.create_state()
            before = {k: v.clone() for k, v in model.state_dict().items()}
            state, losses, ms = timed_steps(task, state, batches, n)
            after = model.state_dict()
            moved = {k: not torch.equal(before[k], after[k]) for k in (
                "image.conv1.kernel", "voxel.conv1.kernel",
                "voxel.final.kernel",
                "image_head.kernel" if fusion == "logit" else "head.kernel")}
            if fusion == "logit":
                moved["fusion_alpha"] = not torch.equal(
                    before["fusion_alpha"], after["fusion_alpha"])
            runs[fusion] = (task, state)
            line[fusion] = {"losses": losses, "ms": ms,
                            "ms_median_after_first": float(np.median(ms[1:])),
                            "moved": moved}
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        line["launches"] = counts
        bad = [f for f in ENS_STEPS if not (
            np.isfinite(line[f]["losses"]).all()
            and all(line[f]["moved"].values()))]
        if bad or not all(counts[k] > 0 for k in ENS_KERNELS):
            raise PhaseError(f"{where}: {line}")

        task, state = runs["logit"]
        batch = batches[0]
        line["repeat_step_bit_identical"] = repeat_identical(task, state,
                                                             batch)
        if not all(line["repeat_step_bit_identical"].values()):
            raise PhaseError(f"{where}: two runs of one step differ: "
                             f"{line['repeat_step_bit_identical']}")
        path = os.path.join(tmp, "ensemble.ckpt")
        checkpoints.save_training_state(path, state)
        twin = ensemble_model("logit", c_in, 6, device)
        task_b, state_b = fresh_state_from(
            path, EnsembleClassificationTraining, twin, **hyper)
        line["restore_next_step_bit_equal"] = bit_equal_after(
            task, state, task_b, state_b, batches[1])
        if not all(line["restore_next_step_bit_equal"].values()):
            raise PhaseError(f"{where}: the restored state's next step "
                             f"differs: {line['restore_next_step_bit_equal']}")

        # eval logits, card against the CPU, on fewer scenes (the image
        # batch padded with black frames to the model's scene slots)
        small = collate_joint([ds[i] for i in range(ENS_CPU_SCENES)],
                              capacity=ENS_CPU_CAPACITY)
        im = small["images"]
        small["images"] = np.concatenate([im, np.zeros(
            (CLS_BATCH - len(im),) + im.shape[1:], im.dtype)])
        cpu_model = copy.deepcopy(state.model).to("cpu")
        cpu_task = EnsembleClassificationTraining(cpu_model, **hyper)
        got, _ = task.eval_step(state, to_device(dict(
            small, labels=np.zeros(ENS_CPU_SCENES, np.int64)), device))
        t0 = time.perf_counter()
        want, _ = cpu_task.eval_step(cpu_task.create_state(), to_device(dict(
            small, labels=np.zeros(ENS_CPU_SCENES, np.int64)), "cpu"))
        cpu_s = time.perf_counter() - t0
        got = got[:ENS_CPU_SCENES].float().cpu()
        want = want[:ENS_CPU_SCENES].float()
        gap = float((got - want).abs().max() / want.abs().max())
        line["eval_card_vs_cpu"] = {"scenes": ENS_CPU_SCENES,
                                    "capacity": ENS_CPU_CAPACITY,
                                    "max_err_of_max": gap,
                                    "cpu_seconds": cpu_s}
        if not gap <= EXTRA_TOL:
            raise PhaseError(f"{where}: eval logits {gap} of max from the "
                             "CPU's")

        # one profiled step, the 2D branch alone, one recorded step
        state, wall, rows = profiled_rows(where, task, state, batch)
        rows = [r for r in rows if not annotation(r[2])]
        dev = sum(r[0] for r in rows)
        line["profile"] = {
            "wall_ms_per_step_profiled": wall, "device_ms_per_step": dev,
            "device_busy_share": dev / line["logit"]["ms_median_after_first"],
            "device_ops_per_step": sum(r[1] for r in rows),
            "custom_kernels_device_ms_per_step": sum(
                r[0] for r in rows if any(k in r[2] for k in CUSTOM_KERNELS))}
        image = copy.deepcopy(state.model.image).train()
        x = batch["images"].permute(0, 3, 1, 2)

        def image_step():
            image.zero_grad(set_to_none=True)
            image(x).sum().backward()

        from nerf_downstream_tpu_torch.train.modules import f32_deterministic

        with f32_deterministic():
            line["profile"]["image_branch_fwd_bwd_device_ms"] = device_ms(
                image_step, reps=3)
        with ClsStepRecorder() as rec:
            state, _ = task.train_step(state, batch)
        line["kernels_per_step"] = cli_kernels_f32(rec, where)
        line["k6_per_step"] = len(rec.k6)
        line["row_gather_matmul"] = k6_calls(where, rec.k6)
        line["tolerance"] = {"logits_card_vs_cpu": f"{EXTRA_TOL} x max|logit|",
                             "k6_f32": f"{K2_F32_TOL} x (1 + sum |x| |w|)"}
        return line, counts, (task, state, batches)
    finally:
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)


def cpu_optimizer_step(name: str, opt, params: list, wd: float) -> dict:
    """The CPU's update of ``opt``'s next step: the optimizer of ``name``
    over CPU copies of ``params`` with ``opt``'s state and lr and the
    parameters' gradients copied over; {index: updated parameter}."""
    import copy

    import torch

    from nerf_downstream_tpu_torch.train.optim import get_optimizer

    cpu = [torch.nn.Parameter(p.detach().cpu().clone()) for p in params]
    for c, p in zip(cpu, params):
        c.grad = None if p.grad is None else p.grad.detach().cpu().clone()
    cpu_opt = get_optimizer(name, cpu, OPT_LR, wd)
    sd = copy.deepcopy(opt.state_dict())
    sd["state"] = {i: {k: v.cpu() if torch.is_tensor(v) else v
                       for k, v in st.items()}
                   for i, st in sd["state"].items()}
    cpu_opt.load_state_dict(sd)
    cpu_opt.step()
    return {i: c.detach() for i, c in enumerate(cpu)}


def phase_optimizers(card: str, ens: tuple, kept_cls: dict,
                     device: str = "cuda") -> tuple[dict, dict]:
    """Each of the nine optimizers of ``train/optim.py`` (the reference's
    optax formulas; gin defaults, ``OPT_LR`` and a constant lr) from the
    ensemble's trained state, ``OPT_STEPS`` steps on its batches, under
    cli_cls's configuration and knobs (``kept["cli_cls"]``) as in phase
    ensemble. Fails unless every loss is finite, every entry of the last
    step's updated parameters on the card is within ``OPT_TOL`` x the
    leaf's largest update, plus ``OPT_ULPS`` x the entry (the rounding of
    its final add), of the same optimizer stepped on the CPU from the
    same state and gradients, and a training
    state saved in the optax layout and restored into a fresh model and
    optimizer gives a bit-equal next step. Prints the ms of each
    optimizer step (between two synchronises) and of each whole step.
    Launch counts are reset just before the first optimizer's steps and
    read just after the last's."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train import checkpoints
    from nerf_downstream_tpu_torch.train.modules import (
        EnsembleClassificationTraining,
    )
    from nerf_downstream_tpu_torch.train.optim import OPTIMIZERS

    where = "optimizers"
    task0, state0, batches = ens
    start = copy.deepcopy(state0.model.state_dict())
    line = {"phase": where, "card": card, "model": "phase ensemble's "
            "(logit fusion) from its trained state", "lr": OPT_LR,
            "steps": OPT_STEPS, "schedule": "none (Rprop refuses one)",
            "tolerance": f"{OPT_TOL} x max|update| per leaf + {OPT_ULPS} x "
                         "|p| per entry, card against the CPU's step on the "
                         "same state and gradients"}
    tmp = tempfile.mkdtemp(prefix="optimizers_")
    try:
        parse_cls_config(kept_cls)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for name in OPTIMIZERS:
            model = state0.model
            model.load_state_dict(start)
            wd = 1e-2 if name == "AdamW" else 1e-4
            kw = dict(optimizer_name=name, scheduler_name="none", lr=OPT_LR,
                      weight_decay=wd)
            task = EnsembleClassificationTraining(model, **kw)
            state = task.create_state()
            opt = state.optimizer
            real_step = opt.step
            opt_ms, check = [], {}
            params = list(model.parameters())

            def timed_step(closure=None):
                last = len(opt_ms) == OPT_STEPS - 1
                if last:
                    before = [p.detach().clone() for p in params]
                    want = cpu_optimizer_step(name, opt, params, wd)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                real_step()
                torch.cuda.synchronize()
                opt_ms.append((time.perf_counter() - t0) * 1e3)
                if last:
                    worst, outside = 0.0, 0
                    for i, p in enumerate(params):
                        upd = float((want[i] - before[i].cpu()).abs().max())
                        err = (p.detach().cpu() - want[i]).abs()
                        outside += int((err > OPT_TOL * upd + OPT_ULPS
                                        * want[i].abs()).sum())
                        worst = max(worst, float(err.max()) / max(upd, 1e-30))
                    check.update(worst_err_of_max_update=worst,
                                 entries_outside=outside)

            opt.step = timed_step
            state, losses, ms = timed_steps(task, state, batches, OPT_STEPS)
            opt.step = real_step
            path = os.path.join(tmp, f"{name}.ckpt")
            checkpoints.save_training_state(path, state)
            twin = copy.deepcopy(model)
            task_b, state_b = fresh_state_from(
                path, EnsembleClassificationTraining, twin, **kw)
            equal = bit_equal_after(task, state, task_b, state_b,
                                    batches[0])
            row = {"losses": losses, "step_ms": ms,
                   "optimizer_step_ms": opt_ms,
                   "optimizer_step_ms_median": float(np.median(opt_ms)),
                   "restore_next_step_bit_equal": equal, **check}
            line[name] = row
            del twin, task_b, state_b
            if not (np.isfinite(losses).all() and all(equal.values())
                    and check["entries_outside"] == 0):
                raise PhaseError(f"{where}: {name}: {row}")
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        line["launches"] = counts
        state0.model.load_state_dict(start)
        return line, counts
    finally:
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)


def weights_tree(model) -> dict:
    """{path: leaf} of ``model``'s params and batch_stats trees."""
    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.utils.prune import flatten

    tree = convert.state_dict_to_flax(model.state_dict(),
                                      convert.flax_layout(model))
    return flatten({"params": tree.get("params", {}),
                    "batch_stats": tree.get("batch_stats", {})})


def host_ms_per_batch(dm, n: int) -> tuple[list, float]:
    """The first two batches of ``dm``'s train stream, and the host ms per
    batch of the ``n`` after them."""
    it = dm.train_batches()
    first = [next(it), next(it)]
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    ms = (time.perf_counter() - t0) * 1e3 / n
    it.close()
    return first, ms


def phase_cli_surface(card: str, kept_cls: dict, device: str = "cuda",
                      bindings=()) -> tuple[dict, dict]:
    """The training CLI (``co3d_3d.train``) on cli_cls's configs, tree and
    pinned knobs and capacity with the rest of the single-card training
    surface bound (``SURFACE_BINDINGS``): AdamW, the csv and tensorboard
    loggers, process workers (the config's 8), and cli_cls's best
    checkpoint loaded with ``transfer_self_supervised``;
    ``SURFACE_STEPS`` steps, then ``--resume`` to
    ``SURFACE_RESUME_STEPS``. Launch counts reset just before the first
    run and read just after the second. Fails unless every loss is
    finite, the first step's weights are the checkpoint's except the
    ``final`` leaves (the model's own), the resumed run's first step
    starts from the checkpoint's weights and AdamW state bit for bit, the
    first two batches equal those of thread workers, no worker process
    outlives the runs, and K1, the pass, K2, K3 and K6 launched. Prints
    which logger path ran (tensorboard's events file, or its warning
    where it cannot be imported) and the host ms per batch of process and
    of thread workers. ``device`` and ``bindings`` (more ``--ginb``, and
    the batch size and workers of the worker comparison) serve a
    rehearsal on the CPU."""
    import contextlib
    import gc
    import io
    import multiprocessing
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.co3d_3d import train as cli
    from nerf_downstream_tpu_torch.data.data_module import DataModule
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train import checkpoints
    from nerf_downstream_tpu_torch.utils.prune import flatten

    where = "cli_surface"
    tmp = tempfile.mkdtemp(prefix="cli_surface_")
    best = os.path.join(kept_cls["save"], "best.ckpt")
    made = []  # the loggers the CLI made
    get_logger = cli.get_logger

    def recording_logger(*a, **kw):
        made.append(get_logger(*a, **kw))
        return made[-1]

    try:
        save = os.path.join(tmp, "exp")
        args = [a for c in CLS_CONFIGS for a in (
            "--ginc", os.path.join(REPO, "co3d_3d", "configs", c))]
        for b in (*cls_bindings(kept_cls), *SURFACE_BINDINGS,
                  f'train.checkpoint_path = "{best}"',
                  f"train.capacity = {kept_cls['capacity']}", *bindings):
            args += ["--ginb", b]
        args += ["--save_path", save, "--seed", "777", "--device", device]
        ckpt = checkpoints.load_checkpoint(best)
        ckpt_leaves = flatten({"params": ckpt["params"],
                               "batch_stats": ckpt["batch_stats"]})
        checks, batches = {}, []

        def on_step(task, state, batch):
            step = int(state.step)
            if step < 2:
                batches.append({k: batch[k].cpu().numpy() for k in (
                    "coordinates", "features", "mask", "labels")})
            if step == 0:
                got = weights_tree(state.model)
                final = [k for k in got if "final" in k]
                checks["first_step_weights"] = {
                    "equal_to_checkpoint_but_final": all(
                        np.array_equal(got[k], ckpt_leaves[k])
                        for k in got if k not in final),
                    "final_kept_the_model's": bool(final) and not all(
                        np.array_equal(got[k], ckpt_leaves[k])
                        for k in final)}
            if step == SURFACE_STEPS:
                last = checkpoints.load_checkpoint(
                    os.path.join(save, "last.ckpt"))
                opt = flatten(checkpoints.optimizer_state_to_optax(
                    state.model, state.optimizer, step,
                    state.schedule is not None))
                want = flatten(last["opt_state"])
                got = weights_tree(state.model)
                wl = flatten({"params": last["params"],
                              "batch_stats": last["batch_stats"]})
                checks["resume"] = {
                    "step": step,
                    "weights_bit_equal": all(np.array_equal(got[k], wl[k])
                                             for k in got),
                    "adamw_state_bit_equal": opt.keys() == want.keys() and all(
                        np.array_equal(opt[k], want[k]) for k in opt)}

        stdout = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        cli.get_logger = recording_logger
        with CliProbe("ClassificationTraining") as probe, \
                contextlib.redirect_stdout(stdout):
            probe.on_step = on_step
            t0 = time.perf_counter()
            gin.clear_config()
            cli.main(args + ["--ginb", f"train.max_steps = {SURFACE_STEPS}"])
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            gin.clear_config()
            cli.main(args + ["--ginb", f"train.max_steps = "
                                       f"{SURFACE_RESUME_STEPS}", "--resume"])
            resume_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        cli.get_logger = get_logger
        task, state, _ = probe.last
        gc.collect()
        workers_left = len(multiprocessing.active_children())
        run = os.path.join(save, f"b{CLS_BATCH}x1-MinkResNetBase")
        tb = [lg for lg in made if type(lg).__name__ == "TensorBoardLogger"]
        events = [f for f in os.listdir(run) if f.startswith("events.")]
        with open(os.path.join(run, "metrics.csv")) as f:
            rows = f.read().splitlines()
        steps = [s for s, _ in probe.steps]
        ms = [m for _, m in probe.steps]
        line = {
            "phase": where, "card": card, "entry":
            "python -m nerf_downstream_tpu_torch.co3d_3d.train",
            "configs": [f"co3d_3d/configs/{c}" for c in CLS_CONFIGS],
            "bindings": list(SURFACE_BINDINGS),
            "optimizer": type(state.optimizer).__name__,
            "steps": steps, "ms": ms, "losses": probe.losses,
            "val_pass_ms": probe.val_ms, "run_seconds": [first_s, resume_s],
            "loggers": {
                "tensorboard": ("events file written" if tb and all(
                    lg.active for lg in tb) and events
                    else "unavailable: warned and disabled"),
                "csv_rows": len(rows)},
            "worker_processes_left": workers_left,
            "launches": counts, **checks}
        ok = (np.isfinite(probe.losses).all() and len(probe.losses) > 0
              and steps == list(range(SURFACE_RESUME_STEPS))
              and line["optimizer"] == "AdamW"
              and all(checks.get("first_step_weights", {"": False}).values())
              and checks.get("resume", {}).get("step") == SURFACE_STEPS
              and checks["resume"]["weights_bit_equal"]
              and checks["resume"]["adamw_state_bit_equal"]
              and workers_left == 0
              and all(counts[k] > 0 for k in ENS_KERNELS))
        if not ok:
            raise PhaseError(f"{where}: {line}")

        # the same stream on process and on thread workers
        parse_cls_config(kept_cls, bindings)
        nw = gin.query_parameter("train.train_num_workers")
        host = {}
        for mode in ("process", "thread"):
            dm = DataModule(batch_size=gin.query_parameter("train.batch_size"),
                            val_batch_size=8, train_num_workers=nw,
                            capacity=kept_cls["capacity"], worker_mode=mode)
            first, host[mode] = host_ms_per_batch(dm, SURFACE_HOST_BATCHES)
            host[f"{mode}_first_two"] = first
        same = all(np.array_equal(a[k], b[k])
                   for a, b in zip(batches[:2], host.pop("thread_first_two"))
                   for k in ("coordinates", "features", "mask"))
        same_p = all(np.array_equal(a[k], b[k]) for a, b in zip(
            batches[:2], host.pop("process_first_two"))
            for k in ("coordinates", "features", "mask"))
        gc.collect()
        line["workers"] = nw
        line["host_ms_per_batch"] = host
        line["first_two_batches_equal_thread_workers"] = same and same_p
        if not (same and same_p) or multiprocessing.active_children():
            raise PhaseError(f"{where}: process and thread workers differ "
                             f"or a worker outlived its stream: {line}")
        return line, counts
    finally:
        cli.get_logger = get_logger
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)


# -- ModelNet40 classification on the row path -------------------------------

# the synthetic ModelNet40 clouds of phase cli_modelnet
# (data.synthetic.modelnet40_arrays): 64 train (2 steps of 32 per epoch)
# and 16 test clouds of 2,048 points in the unit sphere, 40 classes
MN_CLOUDS = dict(n_train=64, n_test=16, n_points=2048, num_classes=40)
MN_STEPS, MN_RESUME_STEPS, MN_VAL_EVERY = 6, 8, 5
MN_BATCH, MN_VAL_BATCH = 32, 16
MN_CONFIG = "modelnet40_cls.gin"
MN_TOL = 1e-4  # of max|logit|: the FCNNs' eval logits, card against CPU
# kernels no FCNN forward or step may launch: every conv takes the row path
WINDOWED_KERNELS = ("window_starts", "window_match", "window_gather_matmul",
                    "window_bwd", "window_dw", "window_gather_matmul_bs")


def modelnet_source(tmp: str, rng, clouds: dict = MN_CLOUDS
                    ) -> tuple[list[str], str]:
    """(gin bindings that give ``ModelNet40H5Dataset`` the ``clouds``
    (MN_CLOUDS unless given), where they come from): HDF5 files the
    port's writer makes where h5py is installed; else the same clouds as
    arrays through the reader's ``arrays`` constructor (a gin reference),
    whose samples the CPU tests hold equal to the file read."""
    import importlib.util

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.data.synthetic import (
        modelnet40_arrays,
        write_modelnet40_tree,
    )

    kw = dict(clouds)
    n = {"train": kw.pop("n_train"), "test": kw.pop("n_test")}
    if importlib.util.find_spec("h5py") is not None:
        root = write_modelnet40_tree(tmp, rng, n["train"], n["test"], **kw)
        return [f'ModelNet40H5Dataset.data_root = "{root}"'], "h5 files"
    arrays = {p: modelnet40_arrays(rng, n[p], **kw) for p in ("train", "test")}
    gin.external_configurable(lambda: arrays, name="smoke_modelnet40_clouds")
    return (["ModelNet40H5Dataset.arrays = @smoke_modelnet40_clouds()"],
            "arrays (h5py is not installed here: the HDF5 read runs in the "
            "CPU tests only)")


def repeat_identical(task, state, batch) -> dict:
    """Two runs of one training step from the same state: whether their
    losses, gradients, updated weights and statistics and momentum
    buffers are bit-identical. The state is left as the second run left
    it."""
    import copy

    import torch

    model, opt = state.model, state.optimizer
    saved = (copy.deepcopy(model.state_dict()),
             copy.deepcopy(opt.state_dict()), state.step)
    runs = []
    for _ in range(2):
        model.load_state_dict(saved[0])
        # a copy: the optimizer adopts the loaded tensors and updates them
        # in place
        opt.load_state_dict(copy.deepcopy(saved[1]))
        state.step = saved[2]
        state, mets = task.train_step(state, batch)
        runs.append((mets["loss"].detach().clone(),
                     {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
                     copy.deepcopy(model.state_dict()),
                     {n: opt.state[p]["momentum_buffer"].clone()
                      for n, p in model.named_parameters()}))
    (l1, g1, s1, m1), (l2, g2, s2, m2) = runs
    return {"loss": bool(torch.equal(l1, l2)),
            "gradients": all(torch.equal(g1[k], g2[k]) for k in g1),
            "state": all(torch.equal(s1[k], s2[k]) for k in s1),
            "momentum": all(torch.equal(m1[k], m2[k]) for k in m1)}


def fcnn_card_vs_cpu(name: str, batch: dict, device: str = "cuda") -> dict:
    """``name`` at full width with seeded weights and norm statistics
    drawn away from identity, eval mode: logits on ``device`` against the
    CPU's on one batch, within MN_TOL x max|logit|."""
    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.models import get_model

    tree = convert.init_flax_variables(get_model(
        name, in_channel=3, out_channel=40), 3)
    out, forward_ms = {}, None
    for dev in dict.fromkeys((device, "cpu")):
        model = get_model(name, in_channel=3, out_channel=40,
                          num_batches=MN_VAL_BATCH)
        convert.load_flax_variables(model, tree)
        model.to(dev).eval()
        field = batch_field({k: torch.as_tensor(batch[k]).to(dev)
                             for k in ("coordinates", "features", "mask")})
        with torch.no_grad():
            out[dev] = model(field).cpu()
            if dev == device:
                forward_ms = device_ms(lambda: model(field), reps=2)
    scale = float(out["cpu"].abs().max())
    err = float((out[device] - out["cpu"]).abs().max())
    line = {"max_abs_err": err, "max_abs_logit": scale,
            "tolerance": MN_TOL * scale,
            "top1_agreement": float((out[device].argmax(-1)
                                     == out["cpu"].argmax(-1)).float().mean()),
            "forward_device_ms": forward_ms}
    if not (np.isfinite(err) and err <= MN_TOL * scale):
        raise PhaseError(f"cli_modelnet: {name} logits off the CPU's: {line}")
    return line


def phase_cli_modelnet(card: str, device: str = "cuda",
                       bindings=()) -> tuple[dict, dict]:
    """``modelnet40_cls.gin`` through the port's training CLI at full
    width: MinkowskiFCNN (channels 32-128, embedding 1024, 40 classes),
    batch 32 of 2,048-point clouds, val batch 16, voxel 0.05, SGD with
    momentum 0.9 and cosine lr, the config's host transforms, f32 (the
    config binds no compute type), on the MN_CLOUDS synthetic clouds
    (``modelnet_source``); only the clouds, ``max_steps``, the validation
    cadence and the logs are bound. ``MN_STEPS`` steps with one
    validation pass, then ``--resume`` to ``MN_RESUME_STEPS``; launch
    counts reset just before the first run and read just after the
    second. The config binds no grid extent, so every conv takes the row
    path: kernel maps by sort and search, K6 forward. Fails unless every
    loss is finite, ``val/acc1`` is logged, the checkpoints and logs
    exist, the resumed run starts at step ``MN_STEPS`` from the
    checkpoint's momentum buffers bit for bit, every conv computes in f32
    on the row path, K6 launched and no windowed kernel did. Then, on the
    run's last batch: two runs of one step bit-identical; one more step
    profiled with its synchronising calls counted; every K6 call of one
    recorded step held against its plain version in f32 (``k6_calls``)
    and timed beside its bound; and the FCNN's and the SplatFCNN's eval
    logits on the card against the CPU's (``fcnn_card_vs_cpu``).
    ``device`` and ``bindings`` serve a rehearsal on the CPU at a narrow
    width."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.co3d_3d import train as cli
    from nerf_downstream_tpu_torch.data.data_module import DataModule
    from nerf_downstream_tpu_torch.data.utils import collate_mink
    from nerf_downstream_tpu_torch.models.mink.layers import SparseConv
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train import checkpoints

    tmp = tempfile.mkdtemp(prefix="cli_modelnet_")
    try:
        t0 = time.perf_counter()
        source, source_is = modelnet_source(tmp, np.random.default_rng(0))
        data_s = time.perf_counter() - t0
        save = os.path.join(tmp, "exp")
        args = ["--ginc", os.path.join(REPO, "co3d_3d", "configs", MN_CONFIG)]
        for b in (*source, f"train.val_every_n_steps = {MN_VAL_EVERY}",
                  "train.log_every_n_steps = 1",
                  'train.loggers = ["csv", "jsonl"]', *bindings):
            args += ["--ginb", b]
        args += ["--save_path", save, "--seed", "777", "--device", device]
        stdout = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with CliProbe("ClassificationTraining") as probe, \
                contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            gin.clear_config()
            cli.main(args + ["--ginb", f"train.max_steps = {MN_STEPS}"])
            first_s = time.perf_counter() - t0
            last = checkpoints.load_checkpoint(os.path.join(save,
                                                            "last.ckpt"))
            probe.resume_trace = convert.flax_to_state_dict(
                probe.last[0].model, last["opt_state"]["1"]["0"]["trace"])
            t0 = time.perf_counter()
            gin.clear_config()
            cli.main(args + ["--ginb", f"train.max_steps = {MN_RESUME_STEPS}",
                             "--resume"])
            resume_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        task, state, batch = probe.last
        run = os.path.join(save, f"b{MN_BATCH}x1-MinkowskiFCNN")
        files = {name: os.path.exists(os.path.join(d, name)) for d, name in (
            (save, "last.ckpt"), (save, "best.ckpt"),
            (run, "metrics.csv"), (run, "metrics.jsonl"))}
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logged = [json.loads(ln) for ln in f]
        train_losses = [r["train/loss"] for r in logged if "train/loss" in r]
        val = [{k: r[k] for k in ("step", "val/loss", "val/acc1",
                                  "val/acc5")}
               for r in logged if "val/acc1" in r]
        convs = [m for m in task.model.modules() if isinstance(m, SparseConv)]
        steps = [s for s, _ in probe.steps]
        ms = [m for _, m in probe.steps]
        prof = probe.profilers[-1]
        line = {
            "phase": "cli_modelnet", "card": card, "entry":
            "python -m nerf_downstream_tpu_torch.co3d_3d.train",
            "config": f"co3d_3d/configs/{MN_CONFIG}",
            "model": type(task.model).__name__,
            "channels": list(task.model.channels),
            "embedding": task.model.embedding_channel,
            "clouds": dict(MN_CLOUDS, seconds=data_s, read_from=source_is),
            "dtype": "float32 (the config binds no compute type; every "
                     "conv on the CUDA cores)",
            "routes": sorted({m.route for m in convs if m.route}),
            "batch": MN_BATCH, "val_batch": MN_VAL_BATCH,
            "capacity": int(batch["mask"].shape[0]),
            "voxels_finest": probe.rows,
            "steps": steps, "ms": ms,
            "ms_median_after_first": float(np.median(ms[1:])),
            "run_seconds": [first_s, resume_s],
            "train_losses": train_losses, "val": val,
            "val_pass_ms": probe.val_ms,
            "host_ms_per_batch_waited": prof.recorded_time(
                "get_train_batch") * 1e3,
            "resume": probe.resume_check, "files": files,
            "launches": counts,
        }
        ok = (all(files.values())
              and np.isfinite(train_losses).all() and len(train_losses) > 0
              and len(val) == 1
              and all(np.isfinite(v["val/loss"])
                      and 0 <= v["val/acc1"] <= 100 for v in val)
              and steps == list(range(MN_RESUME_STEPS))
              and probe.resume_check == {"step": MN_STEPS,
                                         "momentum_bit_equal": True}
              and {m.compute_dtype for m in convs} == {torch.float32}
              and line["routes"] == ["row"]
              and counts["row_gather_matmul"] > 0
              and not any(counts[k] for k in WINDOWED_KERNELS))
        if not ok:
            raise PhaseError(f"cli_modelnet: {line}")

        line["repeat_step_bit_identical"] = repeat_identical(task, state,
                                                             batch)
        if not all(line["repeat_step_bit_identical"].values()):
            raise PhaseError(f"cli_modelnet: two runs of one step differ: "
                             f"{line['repeat_step_bit_identical']}")
        dm = DataModule(batch_size=MN_BATCH, val_batch_size=MN_VAL_BATCH,
                        train_num_workers=1, capacity=line["capacity"])
        rec = cli_extra_steps("cli_modelnet", line, task, state, batch, dm,
                              ClsStepRecorder, 2)
        line["k6_per_step"] = len(rec.k6)
        line["row_gather_matmul"] = k6_calls("cli_modelnet", rec.k6)
        line["tolerance"] = {"k6_f32": f"{K2_F32_TOL} x (1 + sum |x| |w|)",
                             "logits_card_vs_cpu": f"{MN_TOL} x max|logit|"}
        ds = task.datamodule.dataset("val")
        vb = collate_mink([ds[i] for i in range(MN_VAL_BATCH)])
        line["eval_card_vs_cpu"] = {
            name: fcnn_card_vs_cpu(name, vb, device)
            for name in ("MinkowskiFCNN", "MinkowskiSplatFCNN")}
        return line, counts
    finally:
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)


# -- PAConv's trainer and the rest of the 3D registry -------------------------

# the PAConv phase's clouds: 192 train clouds (6 steps of 32 per epoch, so
# the first run validates once, after its last step) and 32 test clouds
# (one validation batch of 32), 2,048 points each, read at 1,024
PACONV_CLOUDS = dict(MN_CLOUDS, n_train=192, n_test=32)
PACONV_POINTS = 1024
PACONV_STEPS, PACONV_RESUME_STEPS, PACONV_OTHER_STEPS = 6, 8, 2
PACONV_OTHERS = ("PAConvPointNet", "DGCNN_cls", "PointNet")
PACONV_TOL = 1e-4  # of max|logit|: eval logits, card against CPU
PACONV_CPU_CLOUDS = 8  # clouds of the card-against-CPU forwards


class AssignScoreRecorder:
    """Records the inputs of every assign-score call of a step (the
    PAConv models' calls; calls go on to the op)."""

    def __enter__(self):
        from nerf_downstream_tpu_torch.models import paconv

        self.calls = []
        self._saved = (paconv.assign_score_withk,
                       paconv.assign_score_withk_halfkernel)
        full, half = self._saved

        def rec_full(scores, points, centers, knn_idx):
            self.calls.append((scores.detach().clone(),
                               points.detach().clone(),
                               centers.detach().clone(), knn_idx))
            return full(scores, points, centers, knn_idx)

        def rec_half(scores, points, knn_idx):
            self.calls.append((scores.detach().clone(),
                               points.detach().clone(), None, knn_idx))
            return half(scores, points, knn_idx)

        paconv.assign_score_withk = rec_full
        paconv.assign_score_withk_halfkernel = rec_half
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.models import paconv

        (paconv.assign_score_withk,
         paconv.assign_score_withk_halfkernel) = self._saved
        return False


def assign_score_ms(calls) -> float:
    """Device ms of one step's assign-score calls, forward and backward
    (the backward's gradient of ones), summed."""
    import torch

    from nerf_downstream_tpu_torch.ops import paconv as ops

    total = 0.0
    for scores, points, centers, idx in calls:
        leaves = [t.clone().requires_grad_(True) for t in
                  (scores, points) + (() if centers is None else (centers,))]

        def run():
            if centers is None:
                out = ops.assign_score_withk_halfkernel(*leaves, idx)
            else:
                out = ops.assign_score_withk(*leaves, idx)
            out.backward(torch.ones_like(out))

        total += device_ms(run, reps=2)
    return total


class KnnRecorder:
    """Records the input and output of every kNN of a forward; with
    ``replay`` (index tensors, one per call), each call returns the next
    of them instead of its own, which it still records."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from nerf_downstream_tpu_torch.models import paconv
        from nerf_downstream_tpu_torch.models.mink import dgcnn

        self.calls = []
        self._saved = (dgcnn.knn, paconv.knn)
        knn = self._saved[0]

        def rec(x, k):
            idx = knn(x, k)
            self.calls.append((x.detach().float().cpu(), idx.cpu(), k))
            if self.replay is not None:
                return self.replay[len(self.calls) - 1].to(idx.device)
            return idx

        dgcnn.knn = paconv.knn = rec
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.models import paconv
        from nerf_downstream_tpu_torch.models.mink import dgcnn

        dgcnn.knn, paconv.knn = self._saved
        return False


def knn_agreement(card_calls, cpu_calls) -> dict:
    """Per kNN call of one forward on the same input: the rows whose
    neighbour sets the card and the CPU chose differently (and those that
    only order them differently, which no model here sees: the edge convs
    and assign-score sum or max over the neighbours), and for the former
    the gap between the k-th and the (k+1)-th candidate in the CPU's
    negated distances, absolute and relative to the k-th: a flip there is
    a near-tie."""
    import torch

    out = []
    for (x, gi, k), (_, ci, _) in zip(card_calls, cpu_calls):
        sets = (torch.sort(gi, -1).values != torch.sort(ci, -1).values
                ).any(-1)
        entry = {"k": k, "rows": int(sets.numel()),
                 "rows_set_differs": int(sets.sum()),
                 "rows_order_only": int(((gi != ci).any(-1) & ~sets).sum()),
                 "margin_max": 0.0, "margin_max_rel": 0.0}
        if sets.any():
            inner = -2 * torch.matmul(x, x.transpose(1, 2))
            xx = (x * x).sum(-1, keepdim=True)
            nd = (-xx - inner - xx.transpose(1, 2))[sets]
            top = torch.sort(nd, dim=-1, descending=True).values
            gap = top[:, k - 1] - top[:, k]
            entry["margin_max"] = float(gap.max())
            entry["margin_max_rel"] = float(
                (gap / top[:, k - 1].abs().clamp(min=1e-30)).max())
        out.append(entry)
    return {"calls": out,
            "rows_set_differs": sum(e["rows_set_differs"] for e in out),
            "rows": sum(e["rows"] for e in out)}


def dense_card_vs_cpu(name: str, batch: dict, device: str = "cuda") -> dict:
    """``name`` at full width with seeded weights and norm statistics
    drawn away from identity, eval mode, on the first PACONV_CPU_CLOUDS
    clouds of ``batch`` (f32, TF32 off): the CPU's forward first, then
    the card's with the CPU's kNN lists carried in, whose logits must
    agree within PACONV_TOL x max|logit|; the card's own kNN lists against
    the CPU's (``knn_agreement``), of which under 1 % of the rows may hold
    another neighbour set (near-ties that the two devices' rounding of
    the same features orders either way: a flip moves that point's edge
    features, and through the pooling every logit, by more than the
    arithmetic's rounding)."""
    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.models import get_model

    x = torch.as_tensor(batch["coordinates"][:PACONV_CPU_CLOUDS])
    tree = convert.init_flax_variables(get_model(
        name, in_channel=3, out_channel=40), 3)

    def forward(dev, replay):
        model = get_model(name, in_channel=3, out_channel=40)
        convert.load_flax_variables(model, tree)
        model.to(dev).eval()
        xd = x.to(dev)
        with torch.no_grad(), KnnRecorder(replay) as rec:
            logits = model(xd).cpu()
        return model, xd, logits, rec.calls

    _, _, cpu_out, cpu_graphs = forward("cpu", None)
    model, xd, card_out, card_graphs = forward(
        device, [i for _, i, _ in cpu_graphs])
    with torch.no_grad():
        forward_ms = device_ms(lambda: model(xd), reps=2)
    out = {"cpu": cpu_out, "card": card_out}
    graphs = {"cpu": cpu_graphs, "card": card_graphs}
    scale = float(out["cpu"].abs().max())
    err = float((out["card"] - out["cpu"]).abs().max())
    agree = knn_agreement(graphs["card"], graphs["cpu"])
    line = {"max_abs_err": err, "max_abs_logit": scale,
            "tolerance": PACONV_TOL * scale,
            "top1_agreement": float((out["card"].argmax(-1)
                                     == out["cpu"].argmax(-1)).float().mean()),
            "knn": agree, "forward_device_ms": forward_ms}
    if not (np.isfinite(err) and err <= PACONV_TOL * scale
            and agree["rows_set_differs"] <= 0.01 * agree["rows"]):
        raise PhaseError(f"cli_paconv: {name} off the CPU's: {line}")
    return line


class NoRecorder:
    """A recorder that records nothing (``cli_extra_steps`` for a path
    without kernels)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def paconv_dm(source):
    """The PAConv CLI's data module on the clouds of ``source`` (its gin
    bindings), one worker."""
    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.co3d_3d import paconv_train as cli
    from nerf_downstream_tpu_torch.data.modelnet40 import ModelNet40H5Dataset

    gin.clear_config()
    gin.parse_config_files_and_bindings(None, list(source))
    gin.bind("ModelNet40H5Dataset", "num_points", PACONV_POINTS)
    return cli.PointCloudDM(ModelNet40H5Dataset, 32, 32, 1, 0)


def phase_cli_paconv(card: str, device: str = "cuda",
                     bindings=()) -> tuple[dict, dict]:
    """The PAConv trainer (``python -m
    nerf_downstream_tpu_torch.co3d_3d.paconv_train``) at its defaults and
    full width: 1,024 points, k 20, batch and val batch 32, SGD with
    momentum 0.9, lr 0.1, weight decay 1e-4, cosine lr, f32, 40 classes,
    on the PACONV_CLOUDS synthetic clouds (``modelnet_source``). No TPU
    kernel lies on this path (kNN, assign-score and the dense layers are
    plain PyTorch, as they are XLA in the reference): launch counts are
    reset before and read after, and every count must stay 0.
    PAConvDGCNN (num_matrices 8, 8, 8, 8) for ``PACONV_STEPS`` steps and
    one validation pass, then ``--resume`` to ``PACONV_RESUME_STEPS``;
    PAConvPointNet, DGCNN_cls and PointNet for ``PACONV_OTHER_STEPS``
    steps each. Fails unless every loss is finite, ``val/acc1`` is logged,
    the resumed run starts at step PACONV_STEPS from the checkpoint's
    momentum buffers bit for bit, two runs of one PAConvDGCNN step are
    bit-identical and each model's eval logits on the card agree with the
    CPU's within PACONV_TOL x max|logit| on the CPU's kNN lists, its own
    lists differing from the CPU's in under 1 % of the rows
    (``dense_card_vs_cpu``). Reports
    ms per step, and for one more PAConvDGCNN step its synchronising
    calls, device time, busy share, device ops, peak memory and
    assign-score's share of the step (its calls timed alone, forward and
    backward). ``device`` and ``bindings`` serve a rehearsal on the CPU
    at a narrow width."""
    import contextlib
    import csv
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.co3d_3d import paconv_train as cli
    from nerf_downstream_tpu_torch.data.utils import collate_pointnet
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train import checkpoints

    tmp = tempfile.mkdtemp(prefix="cli_paconv_")
    try:
        t0 = time.perf_counter()
        source, source_is = modelnet_source(tmp, np.random.default_rng(0),
                                            PACONV_CLOUDS)
        data_s = time.perf_counter() - t0
        args = ["--num_points", str(PACONV_POINTS), "--seed", "0",
                "--device", device]
        for b in (*source, *bindings):
            name, _, value = b.partition("=")
            if name.strip() == "ModelNet40H5Dataset.data_root":
                # the CLI binds its --data_root over any binding
                args += ["--data_root", value.strip().strip('"')]
            else:
                args += ["--ginb", b]
        line = {"phase": "cli_paconv", "card": card, "entry":
                "python -m nerf_downstream_tpu_torch.co3d_3d.paconv_train",
                "clouds": dict(PACONV_CLOUDS, points=PACONV_POINTS,
                               seconds=data_s, read_from=source_is),
                "dtype": "float32", "matmul_precision":
                torch.get_float32_matmul_precision(), "runs": {}}
        stdout = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        runs = [("PAConvDGCNN", PACONV_STEPS, False),
                ("PAConvDGCNN", PACONV_RESUME_STEPS, True)]
        runs += [(m, PACONV_OTHER_STEPS, False) for m in PACONV_OTHERS]
        last_dgcnn = None
        for name, steps, resume in runs:
            save = os.path.join(tmp, name)
            with CliProbe("ClassificationTraining") as probe, \
                    contextlib.redirect_stdout(stdout):
                if resume:
                    raw = checkpoints.load_checkpoint(
                        os.path.join(save, "last.ckpt"))
                    probe.resume_trace = convert.flax_to_state_dict(
                        last_dgcnn[0].model,
                        raw["opt_state"]["1"]["0"]["trace"])
                gin.clear_config()
                t0 = time.perf_counter()
                res = cli.main(args + ["--model", name, "--save_path", save,
                                       "--max_steps", str(steps)]
                               + (["--resume"] if resume else []))
                run_s = time.perf_counter() - t0
            with open(os.path.join(save, "paconv", "metrics.csv")) as f:
                val = [float(r["val/acc1"]) for r in csv.DictReader(f)
                       if r.get("val/acc1")]
            ms = [m for _, m in probe.steps]
            run = {"steps": [s for s, _ in probe.steps], "ms": ms,
                   "losses": probe.losses, "val_acc1_logged": val,
                   "result": res, "val_pass_ms": probe.val_ms,
                   "seconds": run_s}
            if len(ms) > 1:
                run["ms_median_after_first"] = float(np.median(ms[1:]))
            if resume:
                run["resume"] = probe.resume_check
            first = PACONV_STEPS if resume else 0
            ok = (np.isfinite(probe.losses).all() and len(val) > 0
                  and run["steps"] == list(range(first, steps))
                  and np.isfinite(res["val/loss"]))
            if resume:
                ok = ok and probe.resume_check == {
                    "step": PACONV_STEPS, "momentum_bit_equal": True}
            line["runs"][name + (" --resume" if resume else "")] = run
            if not ok:
                raise PhaseError(f"cli_paconv: {name}: {run}")
            if name == "PAConvDGCNN":
                last_dgcnn = probe.last
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        line["launches"] = counts
        line["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if any(counts.values()):
            raise PhaseError(f"cli_paconv: a kernel launched on a path "
                             f"that has none: {counts}")

        task, state, batch = last_dgcnn
        line["repeat_step_bit_identical"] = repeat_identical(task, state,
                                                             batch)
        if not all(line["repeat_step_bit_identical"].values()):
            raise PhaseError("cli_paconv: two runs of one step differ: "
                             f"{line['repeat_step_bit_identical']}")
        dgcnn_run = line["runs"]["PAConvDGCNN"]
        line["ms_median_after_first"] = dgcnn_run["ms_median_after_first"]
        dm = paconv_dm(source)
        cli_extra_steps("cli_paconv", line, task, state, batch, dm,
                        NoRecorder, 2)
        with AssignScoreRecorder() as rec:
            state, _ = task.train_step(state, batch)
        line["assign_score"] = {
            "calls_per_step": len(rec.calls),
            "ms_per_step": assign_score_ms(rec.calls)}
        line["assign_score"]["share_of_step"] = (
            line["assign_score"]["ms_per_step"]
            / line["profile"]["device_ms_per_step"])
        ds = dm.dataset("val")
        vb = collate_pointnet([ds[i] for i in range(PACONV_CPU_CLOUDS)])
        line["tolerance"] = {"logits_card_vs_cpu": f"{PACONV_TOL} x "
                             "max|logit|"}
        line["eval_card_vs_cpu"] = {
            name: dense_card_vs_cpu(name, vb, device)
            for name in ("PAConvDGCNN", *PACONV_OTHERS)}
        return line, counts
    finally:
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)


# phase models_extra: ResUNetBN2C on the row path and EncodedRes16UNet on
# the windowed route, one f32 step each on row_route's serving_8k batch
EXTRA_TOL = 1e-4  # of max|output|: the card's forward against the CPU's
EXTRA_MODELS = {"ResUNetBN2C": ("row", 32), "EncodedRes16UNet": ("windowed",
                                                                20)}


def output_rows(out):
    """A model's output rows: a SparseVoxels' features or the tensor."""
    return out.feats if hasattr(out, "feats") else out


def extra_step(model, field, w):
    """One f32 training step (SGD, lr 0.01, momentum 0.9) of ``model`` on
    a loss linear in its output rows (weights ``w``)."""
    import torch

    model.train()
    rows = output_rows(model(field))
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    opt.zero_grad(set_to_none=True)
    (rows * w)[field.mask].sum().backward()
    opt.step()


def module_outputs(model, field) -> dict:
    """One train-mode forward of ``model`` with a hook on every module:
    each call's output rows and row mask (on the CPU) under
    ``<module>#<call>``, in the order the calls end, the model's output
    under ``<output>#1``; and for each train-mode MaskedBatchNorm how its
    input conditions the one-pass variance it computes (``bn``: the
    largest E[x^2] / (var + eps) over its channels, the f32 one-pass
    variance's largest error relative to var + eps, the least var)."""
    import torch

    from nerf_downstream_tpu_torch.models.mink.layers import MaskedBatchNorm
    from nerf_downstream_tpu_torch.ops.norm import masked_mean_var

    n = field.mask.shape[0]
    out, seen, hooks = {}, {}, []

    def hook(name):
        def fn(mod, inputs, output):
            seen[name] = seen.get(name, 0) + 1
            if hasattr(output, "feats"):
                rows, mask = output.feats, output.mask
            elif torch.is_tensor(output) and output.ndim == 2:
                rows = output
                mask = field.mask if output.shape[0] == n else None
            else:
                return
            entry = {"rows": rows.detach().float().cpu(),
                     "mask": None if mask is None else mask.cpu()}
            if isinstance(mod, MaskedBatchNorm) and mod.training:
                sv = inputs[0]
                x = sv.feats[sv.mask].double()
                var = x.var(0, unbiased=False)
                _, var32 = masked_mean_var(sv.feats, sv.mask)
                entry["bn"] = {
                    "condition": float(((x * x).mean(0)
                                        / (var + mod.eps)).max()),
                    "one_pass_var_err": float(((var32.double() - var).abs()
                                               / (var + mod.eps)).max()),
                    "min_var": float(var.min())}
            out[f"{name}#{seen[name]}"] = entry
        return fn

    for name, mod in model.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(hook(name)))
    model.train()
    try:
        with torch.no_grad():
            final = output_rows(model(field))
    finally:
        for h in hooks:
            h.remove()
    out["<output>#1"] = {"rows": final.detach().float().cpu(),
                         "mask": field.mask.cpu()}
    return out


def rows_gap(got, want, mask=None) -> float:
    """max |got - want| over the valid rows, of the largest |want| there."""
    if mask is not None:
        got, want = got[mask], want[mask]
    if not want.numel():
        return 0.0
    scale = float(want.abs().max())
    d = float((got - want).abs().max())
    return d / scale if scale > 0 else d


def train_divergence(build, failing, device: str = "cuda") -> dict:
    """Where a train-mode forward on the card leaves the CPU's: fresh
    models from ``build(device)`` (model, field) on both sides, every
    module's output compared (``module_outputs``); the first module whose
    valid rows are more than 1e-5 and more than EXTRA_TOL of their
    largest apart, the largest gap, whether the fresh card forward gives
    the card's train-mode output of the gate (``failing``) again bit for
    bit and its gap to the fresh CPU reference, and
    the worst conditioned train-mode BatchNorms."""
    import torch

    recs = {}
    for dev in ("cpu", device):
        model, field = build(dev)
        recs["cpu" if dev == "cpu" else "card"] = module_outputs(model,
                                                                 field)
        del model
    cpu, card = recs["cpu"], recs["card"]
    first = {}
    worst = (0.0, "")
    for key, want in cpu.items():
        got = card.get(key)
        if got is None or got["rows"].shape != want["rows"].shape:
            continue
        g = rows_gap(got["rows"], want["rows"], want["mask"])
        if g > worst[0]:
            worst = (g, key)
        for lim in (1e-5, EXTRA_TOL):
            if g > lim and lim not in first:
                first[lim] = {"module": key, "gap_of_max": g}
    m = card["<output>#1"]["mask"]
    bns = sorted(((e["bn"]["condition"], k, e["bn"]) for k, e in cpu.items()
                  if "bn" in e), key=lambda t: t[0], reverse=True)[:3]
    return {"first_module_over_1e-5": first.get(1e-5),
            "first_module_over_tolerance": first.get(EXTRA_TOL),
            "largest_module_gap": {"module": worst[1] or None,
                                   "gap_of_max": worst[0]},
            "fresh_card_output_equals_failing": bool(torch.equal(
                card["<output>#1"]["rows"][m], failing[m])),
            "fresh_card_output_gap": rows_gap(card["<output>#1"]["rows"],
                                              cpu["<output>#1"]["rows"], m),
            "worst_conditioned_batch_norms": [dict(module=k, **b)
                                              for _, k, b in bns]}


def extra_model(name: str, seed: int, device: str, batch: dict, tree=None):
    """Phase models_extra's model ``name`` on ``device`` with the flax
    variables ``tree`` (drawn from ``seed`` when None), and the batch
    there as a PointField: (model, field, tree)."""
    from nerf_downstream_tpu_torch import convert, serve
    from nerf_downstream_tpu_torch.models import get_model
    from nerf_downstream_tpu_torch.sparse.types import PointField

    route, out_ch = EXTRA_MODELS[name]
    preset = serve.PRESETS["serving_8k"]
    kw = dict(num_batches=preset["scenes"],
              assume_unique=preset["assume_unique"])
    if route == "windowed":
        kw["ctx"] = preset["ctx"]
    model = get_model(name, in_channel=serve.IN_CHANNELS, out_channel=out_ch,
                      **kw)
    tree = tree or convert.init_flax_variables(model, seed)
    convert.load_flax_variables(model, tree)
    model.to(device)
    t = serve.to_device(batch, device)
    field = PointField(coords=t["coordinates"], feats=t["features"],
                       mask=t["mask"])
    return model, field, tree


def phase_models_extra(card: str, device: str = "cuda") -> tuple[dict, dict]:
    """The rest of the 3D registry, one f32 training step each on the
    ``serving_8k`` batch that row_route uses, at full width with seeded
    weights: ResUNetBN2C (channels 32-256, every conv on the row path: K6
    forwards) and EncodedRes16UNet (Res16UNet trunk at its factory widths
    on the preset's windowed knobs: K1, the window-starts pass, K2-K4;
    its trunk's first conv takes K4, ``input_grad=False``). Launch counts
    are reset before each step and read after; every K6 call of the
    ResUNet's step is held to its plain version (``k6_calls``), every K1-K4
    call of the Encoded model's step to its plain version
    (``cli_kernels_f32``), each timed beside its bound. Then the gates:
    the card's eval-mode output and its train-mode output (batch
    statistics), each from the weights before the step, within EXTRA_TOL
    x max of the CPU's on the same weights and batch (the port's CPU sums
    repeat at any thread count: ``ops/scatter.py``);
    and whether two
    train-mode forwards on the card are bit-identical (reported). Where
    an output gate fails, ``train_divergence`` names the first module at
    which the card leaves the CPU."""
    import copy

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import serve
    from nerf_downstream_tpu_torch.models.mink.layers import (
        SparseConv,
        SparseConvTranspose,
    )
    from nerf_downstream_tpu_torch.ops import kernels

    batch = serve.make_batch("serving_8k", np.random.default_rng(2))
    line = {"phase": "models_extra", "card": card, "preset": "serving_8k",
            "dtype": "float32", "rows": int(batch["mask"].sum()),
            "cpu_threads": torch.get_num_threads(),
            "tolerance_of_max": EXTRA_TOL}
    total = {}
    for seed, (name, (route, out_ch)) in enumerate(EXTRA_MODELS.items()):
        tree = None
        outs = {}
        for dev in ("cpu", device):
            model, field, tree = extra_model(name, seed, dev, batch, tree)
            side = "cpu" if dev == "cpu" else "card"
            with torch.no_grad():
                model.eval()
                outs[side, "eval"] = output_rows(model(field)).cpu()
                model.train()
                outs[side, "train"] = output_rows(model(field)).cpu()
            if dev == "cpu":
                continue
            twin = copy.deepcopy(model)
            with torch.no_grad():
                repeat = bool(torch.equal(output_rows(twin(field)).cpu(),
                                          outs["card", "train"]))
            del twin
            w = torch.as_tensor(np.random.default_rng(9).normal(
                size=(field.mask.shape[0], out_ch)).astype(np.float32),
                device=dev) / float(field.mask.sum())
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with ClsStepRecorder() as rec:
                extra_step(model, field, w)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            step_ms = device_ms(lambda: extra_step(model, field, w), reps=2)
        m = torch.as_tensor(batch["mask"])
        gaps = {mode: rows_gap(outs["card", mode], outs["cpu", mode], m)
                for mode in ("eval", "train")}
        convs = [c for c in model.modules()
                 if isinstance(c, (SparseConv, SparseConvTranspose))]
        entry = {"route": route, "routes": sorted({c.route for c in convs
                                                   if c.route}),
                 "gap_of_max": gaps,
                 "max_abs_output": {mode: float(outs["cpu", mode][m].abs()
                                                .max())
                                    for mode in ("eval", "train")},
                 "launches": counts,
                 "train_forward_repeat_bit_identical": repeat,
                 "step_device_ms": step_ms}
        if entry["routes"] != [route]:
            raise PhaseError(f"models_extra: {name}: {entry}")
        if route == "row":
            if counts["row_gather_matmul"] <= 0 or any(
                    counts[k] for k in WINDOWED_KERNELS):
                raise PhaseError(f"models_extra: {name} launches {counts}")
            entry["row_gather_matmul"] = k6_calls("models_extra", rec.k6)
        else:
            for k in CLI_KERNELS:
                if counts[k] <= 0:
                    raise PhaseError(f"models_extra: {name}: kernel {k} "
                                     "never launched")
            entry["kernels"] = cli_kernels_f32(rec, "models_extra")
            if rec.k6:
                entry["row_gather_matmul"] = k6_calls("models_extra",
                                                      rec.k6)
        del rec, model
        if not all(np.isfinite(g) and g <= EXTRA_TOL for g in gaps.values()):
            entry["divergence"] = train_divergence(
                lambda dev, n=name, s=seed, t=tree:
                    extra_model(n, s, dev, batch, t)[:2],
                outs["card", "train"], device)
            raise PhaseError(f"models_extra: {name}: {entry}")
        line[name] = entry
    line["launches"] = total
    return line, total


# -- the 2D classification stack ---------------------------------------------

# the synthetic frame tree of phases cli_2d and cli_2d_vit
# (data.synthetic.write_perfception_2d_tree): 64 train scenes (2 steps of
# 32 per epoch), 8 val and 8 test scenes of 4 frames (one validation
# batch of 32), frames of 320 x 240
FRAMES_2D = dict(n_train=64, n_val=8, n_test=8, frames=4, size=(320, 240))
MODEL_2D_BATCH = 32
# of max|logit|: the port's f32 on the card against its f32 on the CPU,
# and bf16 on the card against f32 on the card
MODEL_2D_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (config, max_epochs, check_val_every_n_epoch): 6 and 4 steps, one
# validation pass each, then a resume for one more epoch (2 steps)
CLI_2D = {"cli_2d": ("ours_scratch_bkgd/resnet50.gin", 3, 2),
          "cli_2d_vit": ("ours_scratch/vitbase.gin", 2, 1)}


def randomise_norms(model, seed: int):
    """Every norm's scale, bias and running statistics drawn away from
    identity (a fresh init zeroes each residual branch's last BatchNorm
    scale, which would leave the branches out of a comparison)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            leaf = key.rsplit(".", 1)[-1]
            if leaf in ("scale", "ls1", "ls2"):
                v = rng.uniform(0.5, 1.5, t.shape)
            elif leaf == "var":
                v = rng.uniform(0.5, 2.0, t.shape)
            elif leaf in ("bias", "mean"):
                v = rng.normal(size=t.shape) * 0.1
            else:
                continue
            t.copy_(torch.as_tensor(v, dtype=t.dtype))
    return model


def phase_model_2d(card: str, device: str = "cuda") -> dict:
    """ResNet50 and ViT-B/16 at 224 x 224, batch 32, seeded weights, eval
    mode: the port's f32 on the card (TF32 off) against its f32 on the
    CPU within 1e-4 x max|logit|, and bf16 on the card against f32 on the
    card within 5e-2 x max|logit|; top-1 agreement, the gaps, and the
    device time of each forward."""
    import copy

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch.co3d_2d.train import f32_without_tf32
    from nerf_downstream_tpu_torch.models.image import (
        ResNetBased,
        ViTBased,
        init_weights,
    )

    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(MODEL_2D_BATCH, 3, 224, 224)).astype(np.float32))
    line = {"phase": "model_2d", "card": card, "batch": MODEL_2D_BATCH,
            "image": 224, "tolerance_of_max_logit": MODEL_2D_TOL}
    for name, build in (("resnet50", ResNetBased),
                        ("vit_base_patch16_224", ViTBased)):
        ref = randomise_norms(init_weights(build(name), 0), 1).eval()
        with torch.no_grad():
            cpu = ref(x)
        f32 = copy.deepcopy(ref).to(device)
        bf16 = build(name, dtype=torch.bfloat16).eval()
        bf16.load_state_dict(ref.state_dict())
        bf16.to(device)
        xd = x.to(device)
        out = {}
        with torch.no_grad(), f32_without_tf32():
            if not (torch.backends.cudnn.allow_tf32 is False
                    and torch.backends.cuda.matmul.allow_tf32 is False):
                raise PhaseError("model_2d: TF32 is on under f32")
            for dtype, model in (("float32", f32), ("bfloat16", bf16)):
                logits = model(xd)
                out[dtype] = {"logits": logits.float().cpu(),
                              "ms": device_ms(lambda m=model: m(xd))}
        scale = float(cpu.abs().max())
        gaps = {"float32_vs_cpu": float(
                    (out["float32"]["logits"] - cpu).abs().max()) / scale,
                "bfloat16_vs_float32": float(
                    (out["bfloat16"]["logits"] - out["float32"]["logits"])
                    .abs().max()) / scale}
        top1 = {k: float((out[k]["logits"].argmax(-1) == cpu.argmax(-1))
                         .float().mean()) for k in out}
        line[name] = {"max_abs_logit": scale, "gap_of_max_logit": gaps,
                      "top1_agreement_with_cpu": top1,
                      "forward_ms": {k: out[k]["ms"] for k in out},
                      "finite": bool(all(torch.isfinite(out[k]["logits"])
                                         .all() for k in out))}
        if not (line[name]["finite"]
                and gaps["float32_vs_cpu"] <= MODEL_2D_TOL["float32"]
                and gaps["bfloat16_vs_float32"] <= MODEL_2D_TOL["bfloat16"]):
            raise PhaseError(f"model_2d: {name}: {line[name]}")
    return line


def annotation(key: str) -> bool:
    """Whether a device row of a profile is a user annotation
    (``Optimizer.step#SGD.step``), which overlaps the kernels it names,
    rather than a kernel (kernel names may hold ``#`` too, as in
    ``{lambda()#3}``)."""
    return key.startswith("Optimizer.")


def kernel_share(rows) -> dict:
    """Device ms of a profiled step by kind of kernel (by name): cuDNN
    convolutions (forward, data and weight gradients), matrix products
    (cuBLAS, CUTLASS), BatchNorm, LayerNorm, reductions (the BatchNorm
    statistics' Welford pass, norms, sums), copies and casts, and other
    elementwise kernels. ``rows`` holds no user annotation
    (``annotation``)."""
    kinds = (("conv", ("fprop", "dgrad", "wgrad", "conv")),
             ("gemm", ("gemm", "nvjet", "cutlass")),
             ("batch_norm", ("batch_norm",)),
             ("layer_norm", ("layer_norm", "gammabeta")),
             ("reduce", ("reduce_kernel", "norm")),
             ("copy_cast", ("copy",)))
    out = {f"{k}_ms": 0.0 for k, _ in kinds}
    out["elementwise_other_ms"] = 0.0
    for ms, _, key in rows:
        k = key.lower()
        kind = next((f"{n}_ms" for n, subs in kinds
                     if any(x in k for x in subs)), "elementwise_other_ms")
        out[kind] += ms
    return out


class Cli2DProbe:
    """Wraps the 2D task's step, the Trainer's validation pass, fit and
    constructor while the port's 2D CLI runs: each step's wall time (a
    synchronise on either side) and loss, each validation pass's wall
    time, each Trainer's profiler, a copy of the state each fit ends with,
    and, for a resumed run, its first step checked against ``resume``
    (the checkpoint's weights and momentum trace, bit for bit) with that
    step's batch and loss kept."""

    def __init__(self):
        self.steps: list[tuple[int, float, float]] = []
        self.val_ms: list[float] = []
        self.profilers: list = []
        self.fit_ends: list = []
        self.last = None
        self.resume = None  # (params state_dict, momentum by name)
        self.resume_check = None

    def __enter__(self):
        import copy

        import torch

        from nerf_downstream_tpu_torch.train import loop, modules2d

        probe = self
        cls = modules2d.LitModel
        self._saved = (cls.train_step, loop.Trainer.validate,
                       loop.Trainer.fit, loop.Trainer.__init__)
        step_fn, validate, fit, init = self._saved

        def train_step(task, state, batch):
            if probe.resume is not None and probe.resume_check is None:
                weights, trace = probe.resume
                sd = state.model.state_dict()
                probe.resume_check = {
                    "step": int(state.step),
                    "weights_bit_equal": all(
                        torch.equal(sd[k].cpu(), v)
                        for k, v in weights.items()),
                    "momentum_bit_equal": all(
                        torch.equal(state.optimizer.state[p][
                            "momentum_buffer"].cpu(), trace[n])
                        for n, p in state.model.named_parameters())}
                probe.resume_batch = batch
            step = int(state.step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(task, state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            probe.steps.append((step, ms, float(out[1]["loss"])))
            probe.last = (task, out[0], batch)
            return out

        def timed_validate(trainer, state, phase="val"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = validate(trainer, state, phase)
            torch.cuda.synchronize()
            probe.val_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def kept_fit(trainer, state=None):
            out = fit(trainer, state)
            probe.fit_ends.append(copy.deepcopy(out))
            return out

        def recorded_init(trainer, *a, **kw):
            init(trainer, *a, **kw)
            probe.profilers.append(trainer.profiler)

        cls.train_step = train_step
        loop.Trainer.validate = timed_validate
        loop.Trainer.fit = kept_fit
        loop.Trainer.__init__ = recorded_init
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.train import loop, modules2d

        (modules2d.LitModel.train_step, loop.Trainer.validate,
         loop.Trainer.fit, loop.Trainer.__init__) = self._saved
        return False


def phase_cli_2d(card: str, where: str, device: str = "cuda",
                 bindings=()) -> dict:
    """The port's 2D CLI (``co3d_2d/train.py``) on a ``co3d_2d`` config
    unchanged at full width (``CLI_2D[where]``: batch 32 of 224 crops,
    eval chunks 32, ``precision = 16`` -> bf16, SGD lr 0.1 with warmup,
    AugMix, 8 loader workers), only the data paths, file lists,
    ``frames_per_scene``, ``max_epochs``, ``check_val_every_n_epoch`` and
    the log directory bound, on ``FRAMES_2D``; then a resume from
    ``last.ckpt`` for one more epoch. Fails unless every loss is finite,
    ``val/acc`` is logged, ``best.ckpt`` and ``last.ckpt`` exist, the
    model computes in bf16, and the resumed run starts at the checkpoint's
    step from its weights and momentum bit for bit and its first loss
    equals, bit for bit, the loss the first run's final state gives on
    that batch. Then one more step's synchronising calls and profile, and
    host ms per batch on one worker. ``device`` and ``bindings`` serve a
    rehearsal on the CPU."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.co3d_2d import train as cli
    from nerf_downstream_tpu_torch.data.loader2d import DataModule2D
    from nerf_downstream_tpu_torch.data.synthetic import (
        write_perfception_2d_tree,
    )
    from nerf_downstream_tpu_torch.models.image.layers import Conv2d, Dense
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train import checkpoints

    config, epochs, val_every = CLI_2D[where]
    tmp = tempfile.mkdtemp(prefix=f"{where}_")
    try:
        t_start = time.perf_counter()
        p = write_perfception_2d_tree(tmp, np.random.default_rng(0),
                                      **FRAMES_2D)
        tree_s = time.perf_counter() - t_start
        logs = os.path.join(tmp, "logs")
        args = ["--ginc", os.path.join(REPO, "co3d_2d", "configs", config)]
        sets = [f"PeRFCeptionCo3D{k}Dataset" for k in ("Train", "Eval")]
        for b in (
                *(f'{c}.data_root = "{p["perfception"]}"' for c in sets),
                *(f'{c}.filelist_dir = "{p["filelist"]}"' for c in sets),
                "PeRFCeptionCo3DTrainDataset.frames_per_scene = "
                f"{FRAMES_2D['frames']}",
                f"run.check_val_every_n_epoch = {val_every}",
                f'run.log_dir = "{logs}"', *bindings):
            args += ["--ginb", b]
        args += ["--seed", "0", "--device", device]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with Cli2DProbe() as probe:
            t0 = time.perf_counter()
            gin.clear_config()
            results = cli.main(args + ["--ginb", f"run.max_epochs = {epochs}"])
            first_s = time.perf_counter() - t0
            task = probe.last[0]
            run = os.path.join(
                logs, f"{gin.query_parameter('run.run_name')}_0")
            last = checkpoints.load_checkpoint(os.path.join(run, "last.ckpt"))
            weights = convert.flax_to_state_dict(
                task.model, {"params": last["params"],
                             "batch_stats": last["batch_stats"]})
            trace = convert.flax_to_state_dict(
                task.model, last["opt_state"]["0"]["trace"])
            probe.resume = (weights, trace)
            final = probe.fit_ends[-1]
            n_first = len(probe.steps)
            t0 = time.perf_counter()
            gin.clear_config()
            cli.main(args + ["--ginb", f"run.max_epochs = {epochs + 1}",
                             "--ckpt_path", os.path.join(run, "last.ckpt"),
                             "--resume_training", "true"])
            resume_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        resumed_loss = probe.steps[n_first][2]
        _, again = task.train_step(final, probe.resume_batch)
        steps = [s for s, _, _ in probe.steps]
        ms = [m for _, m, _ in probe.steps]
        losses = [v for _, _, v in probe.steps]
        with open(os.path.join(run, "metrics.csv")) as f:
            logged = f.read()
        prof = probe.profilers[0]
        model = probe.last[1].model
        heads = [getattr(model, n, None) for n in ("fc", "head")]
        dtypes = sorted({str(m.dtype) for m in model.modules()
                         if isinstance(m, (Conv2d, Dense))
                         and all(m is not h for h in heads)})
        line = {
            "phase": where, "card": card,
            "entry": "python -m nerf_downstream_tpu_torch.co3d_2d.train",
            "config": f"co3d_2d/configs/{config}",
            "model": task.model_name, "compute_dtypes": dtypes,
            "batch": int(probe.last[2]["images"].shape[0]),
            "image": list(probe.last[2]["images"].shape[1:3]),
            "tree": dict(FRAMES_2D, seconds=tree_s),
            "steps": steps, "ms": ms, "losses": losses,
            "ms_median_after_first": float(np.median(ms[1:n_first])),
            "run_seconds": [first_s, resume_s],
            "val_pass_ms": probe.val_ms,
            "host_ms_per_batch_waited_8_workers": prof.recorded_time(
                "get_train_batch") * 1e3,
            "test_results": {k: float(v) for k, v in results.items()},
            "val_acc_logged": "val/acc" in logged,
            "files": {n: os.path.exists(os.path.join(run, n))
                      for n in ("best.ckpt", "last.ckpt", "metrics.csv")},
            "resume": dict(probe.resume_check or {},
                           first_loss=resumed_loss,
                           from_first_runs_state=float(again["loss"])),
            "custom_kernel_launches": counts,
        }
        ok = (all(line["files"].values()) and line["val_acc_logged"]
              and np.isfinite(losses).all()
              and steps == list(range(n_first + 2))
              and n_first == 2 * epochs
              and dtypes == ["torch.bfloat16"]
              and probe.resume_check == {"step": n_first,
                                         "weights_bit_equal": True,
                                         "momentum_bit_equal": True}
              and resumed_loss == float(again["loss"])
              and not any(counts.values()))
        if not ok:
            raise PhaseError(f"{where}: {line}")

        # one more step: synchronising calls, a profile, the host
        task, state, batch = probe.last

        def step():
            nonlocal state
            state, _ = task.train_step(state, batch)

        line["sync"] = sync_count(where, step)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [r for r in device_rows(prof_, 1) if not annotation(r[2])]
        dev = sum(r[0] for r in rows)
        if dev <= 0:
            raise PhaseError(f"{where}: the profiler saw no device time")
        run_step = (prof.recorded_time("get_train_batch")
                    + prof.recorded_time("run_training_batch")) * 1e3
        line["profile"] = {
            "wall_ms_per_step_profiled": wall,
            "device_ms_per_step": dev,
            "device_busy_share": dev / line["ms_median_after_first"],
            "ms_per_step_of_the_run": run_step,
            "device_share_of_the_run": dev / run_step,
            "device_ops_per_step": sum(r[1] for r in rows),
            **kernel_share(rows),
            "top_device": [{"name": k[:90], "per_step": c, "ms": m}
                           for m, c, k in rows[:16]]}
        dm = DataModule2D(num_workers=1)
        it = dm.train_batches()
        next(it)
        t0 = time.perf_counter()
        for _ in range(2):
            next(it)
        line["host_ms_per_batch_one_worker"] = (
            (time.perf_counter() - t0) * 1e3 / 2)
        line["seconds"] = time.perf_counter() - t_start
        return line
    finally:
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)


class SparseRecorder:
    """Records the inputs of every K5 and K6 call of a forward, by wrapping
    the names the package's modules call. Calls go on to the real
    wrappers."""

    def __init__(self):
        self.k5: list[tuple] = []
        self.k6: list[tuple] = []

    def __enter__(self):
        from nerf_downstream_tpu_torch.ops import sparse_conv, window_conv

        self._saved = (window_conv.window_gather_matmul_bs,
                       sparse_conv.row_gather_matmul)
        bs, rg = self._saved

        def rec_bs(feats, starts, idx, w, live, block, masked=False):
            if not masked:
                raise PhaseError("the block tier passed K5 unmasked weights")
            self.k5.append((feats.clone(), starts.clone(), idx.clone(),
                            w.clone(), live.clone(), block))
            return bs(feats, starts, idx, w, live, block, masked=True)

        def rec_rg(x_ext, km, w):
            self.k6.append((x_ext.clone(), km.clone(), w.clone()))
            return rg(x_ext, km, w)

        window_conv.window_gather_matmul_bs = rec_bs
        sparse_conv.row_gather_matmul = rec_rg
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.ops import sparse_conv, window_conv

        (window_conv.window_gather_matmul_bs,
         sparse_conv.row_gather_matmul) = self._saved
        return False


def pruned_params(params: dict, how, seed: int = 0) -> dict:
    """A pruned copy of a parameter tree. ``"zaxis"``: every conv kernel
    but the transposes keeps its z-column offsets; ``"offsets"``: 3x3x3
    kernels keep ``UNIFORM_OFFSETS``, 2x2x2 ones ``DOWN_OFFSETS``; an int
    b: half of every offset's b x b weight blocks (rounded down) zeroed,
    in kernels with more than one block."""
    import numpy as np

    from nerf_downstream_tpu_torch.ops.weight_sparse import zaxis_offsets
    from nerf_downstream_tpu_torch.sparse import kernel_offsets
    from nerf_downstream_tpu_torch.utils.prune import flatten, unflatten

    rng = np.random.default_rng(seed)
    flat = flatten(params)
    for path, arr in flat.items():
        k = arr.shape[0]
        if path[-1] != "kernel" or k == 1:
            continue
        out = arr.copy()
        if how in ("zaxis", "offsets"):
            if how == "zaxis":
                if path[0].startswith("convtr"):
                    continue  # transpose convs are dense in every mode
                keep = zaxis_offsets(kernel_offsets(3 if k == 27 else 2, 1))
            else:
                keep = UNIFORM_OFFSETS if k == 27 else DOWN_OFFSETS
            out[:] = 0
            out[list(keep)] = arr[list(keep)]
        else:
            b = how
            nbi, nbo = -(-arr.shape[1] // b), -(-arr.shape[2] // b)
            if nbi * nbo < 2:
                continue
            for kk in range(k):
                for p in rng.permutation(nbi * nbo)[:nbi * nbo // 2]:
                    bi, bo = divmod(int(p), nbo)
                    out[kk, bi * b:(bi + 1) * b, bo * b:(bo + 1) * b] = 0
        flat[path] = out
    return unflatten(flat)


def spread(values) -> dict:
    """Median, quartiles and range of a list of times."""
    import numpy as np

    v = np.asarray(values, dtype=float)
    return {"n": int(v.size), "median": float(np.median(v)),
            "p25": float(np.percentile(v, 25)),
            "p75": float(np.percentile(v, 75)),
            "min": float(v.min()), "max": float(v.max())}


def request_times(model, batches, n: int) -> list[float]:
    """Host wall ms of ``n`` requests of ``model``, each ended by a
    synchronise, cycling over ``batches`` after one untimed warm-up."""
    import torch

    from nerf_downstream_tpu_torch import serve

    serve.eval_step(model, batches[0])
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.eval_step(model, batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def overflow_check(model) -> dict:
    """The capacity guard on the card: the dense model over the request
    of seed 0 whose first down conv overflows its window coverage must
    poison that request (and no other plan may overflow), as the
    reference's guard does."""
    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import serve
    from nerf_downstream_tpu_torch.ops import window_conv

    rng = np.random.default_rng(0)
    for _ in range(OVERFLOWING_REQUEST + 1):
        batch = serve.make_batch("eval_64k", rng)
    batch = serve.to_device(batch, "cuda")
    build = window_conv.build_plan_direct
    plans = []

    def recording(coords, mask, offsets, **kw):
        plan = build(coords, mask, offsets, **kw)
        if int(plan.n_escaped) > 0:
            plans.append({"table_rows": int(mask.sum()),
                          "offsets": len(offsets),
                          "cross": kw.get("out_coords") is not None,
                          "coverage": kw["blocks"] * kw["window"]})
        return plan

    window_conv.build_plan_direct = recording
    try:
        logits, mets = serve.eval_step(model, batch)
    finally:
        window_conv.build_plan_direct = build
    out = {"request": f"seed 0, request {OVERFLOWING_REQUEST}",
           "overflowing_plans": plans,
           "loss_is_nan": bool(np.isnan(float(mets["loss"]))),
           "poisoned_rows": float(torch.isnan(logits[batch["mask"]])
                                  .float().mean())}
    want = [{"table_rows": 62400, "offsets": 8, "cross": True,
             "coverage": 1536}]
    if plans != want or out["poisoned_rows"] != 1.0 or not out["loss_is_nan"]:
        raise PhaseError(f"capacity guard: {out}, want plans {want} and "
                         "every row poisoned")
    return out


def wall_in_turns(a, b, batches, turns: int = WALL_TURNS) -> dict:
    """Host wall ms per request of models ``a`` and ``b`` over the same
    requests, timed in ``turns`` turns of (a, b, b, a) so that host noise
    falls on both. Each turn gives one time per model (the mean of its two
    runs) and one paired gap b - a; the gap is resolved only when every
    turn puts it on the same side of zero."""
    import torch

    from nerf_downstream_tpu_torch import serve

    def run(model) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            serve.eval_step(model, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(batches)

    ta, tb, gaps = [], [], []
    for _ in range(turns):
        t: dict = {"a": [], "b": []}
        for which in "abba":
            t[which].append(run(a if which == "a" else b))
        ta.append(sum(t["a"]) / 2)
        tb.append(sum(t["b"]) / 2)
        gaps.append(tb[-1] - ta[-1])
    gap = spread(gaps)
    return {"turns": turns, "requests_per_run": len(batches),
            "a_ms": spread(ta), "b_ms": spread(tb), "gap_ms": gap,
            "gap_of_a": gap["median"] / spread(ta)["median"],
            "resolved": gap["min"] > 0 or gap["max"] < 0}


def _flag(flags: list, name: str, default):
    return flags[flags.index(name) + 1] if name in flags else default


def phase_sparse_eval(card: str) -> tuple[dict, dict, dict]:
    """The pruned-eval path: for each of ``SPARSE_CONFIGS`` a checkpoint
    written by the port's ``save_checkpoint`` (seeded weights, pruned as
    the configuration says) goes through ``eval3d.main`` at ``eval_64k``
    in bf16, launch counts reset just before and read just after; then
    ``SPARSE_REQUESTS`` timed requests, a profile of 3 requests, their
    wall time in ``WALL_TURNS`` turns with the dense model,
    one recorded forward (K5 and K6 calls), and the f32 logits against the
    dense model on the same weights; last, ``overflow_check``. Returns
    (phase line, launch counts, {"k5": {config: calls}, "k6": ...})."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import convert, eval3d, serve
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train.checkpoints import (
        load_checkpoint,
        save_checkpoint,
    )

    init = convert.init_flax_variables(
        eval3d.get_model("Res16UNet18A", in_channel=serve.IN_CHANNELS,
                         out_channel=serve.NUM_CLASSES), 0)
    batch = serve.to_device(
        serve.make_batch("eval_64k", np.random.default_rng(1)), "cuda")
    rng = np.random.default_rng(2)
    prof_batches = [serve.to_device(serve.make_batch("eval_64k", rng),
                                    "cuda") for _ in range(3)]
    valid = batch["mask"]
    dense16 = eval3d.build_evaluator("eval_64k", init, device="cuda")
    down = {f"conv{i}_conv" for i in range(1, 5)}
    line = {"phase": "sparse_eval", "card": card, "preset": "eval_64k",
            "dtype": "torch.bfloat16", "batches": SPARSE_BATCHES,
            "wall_turns": WALL_TURNS,
            "tolerance_of_max_logit": SPARSE_TOL, "configs": {}}
    launches = {name: 0 for name in kernels.launch_counts()}
    recs: dict = {"k5": {}, "k6": {}}
    total_convs = None
    with tempfile.TemporaryDirectory() as tmp:
        for name, (how, flags) in SPARSE_CONFIGS.items():
            params = (init["params"] if how is None
                      else pruned_params(init["params"], how))
            ckpt = os.path.join(tmp, name, "last.ckpt")
            save_checkpoint(ckpt, params, init["batch_stats"],
                            meta={"seed": 0, "pruning": str(how)})
            argv = ["--preset", "eval_64k", "--load_path", ckpt, "--tag",
                    name, "--batches", str(SPARSE_BATCHES), "--seed", "0",
                    *flags]
            log = io.StringIO()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with contextlib.redirect_stdout(log):
                res = eval3d.main(argv)
            counts = kernels.launch_counts()
            for k, v in counts.items():
                launches[k] += v
            # the maps eval3d derived, for the route and launch checks
            raw = load_checkpoint(ckpt)
            variables = {"params": raw["params"],
                         "batch_stats": raw["batch_stats"]}
            modes = eval3d.parse_sparse_mode(
                "--sparsify" in flags, _flag(flags, "--sparse_mode", ""))
            gran = int(_flag(flags, "--block_live_granularity", 128))
            with contextlib.redirect_stdout(io.StringIO()):
                vmap, bmap = eval3d.derive_maps(
                    variables["params"], modes,
                    _flag(flags, "--layout", "csr"), gran)
            routes = res["routes"]
            if total_convs is None:
                total_convs = sum(routes.values())
            n_row = 4 if how == "zaxis" else len(down & set(vmap or {}))
            n_bs = len([p for p in (bmap or {})
                        if not p.startswith("convtr")])
            want = {"windowed": total_convs - n_row - n_bs, "row": n_row,
                    "blocksparse": n_bs}
            want = {k: v for k, v in want.items() if v}
            cfg = {
                "pruning": str(how), "flags": flags,
                "log": [ln for ln in log.getvalue().splitlines()
                        if ln.startswith(("num_params", "folded"))],
                "results": res["results"], "ms": res["ms"],
                "routes": routes, "launches": counts,
                "launches_per_request": {k: v / SPARSE_BATCHES
                                         for k, v in counts.items()},
                "offset_map_entries": len(vmap or {}),
                "block_map_entries": len(bmap or {}),
            }
            line["configs"][name] = cfg
            if routes != want:
                raise PhaseError(f"{name}: routes {routes}, want {want}")
            want_k = {"window_gather_matmul_bs": n_bs * SPARSE_BATCHES,
                      "row_gather_matmul": n_row * SPARSE_BATCHES}
            for k in WINDOW_KERNELS:
                if counts[k] <= 0:
                    raise PhaseError(f"{name}: kernel {k} never launched")
            for k, n in want_k.items():
                if counts[k] != n:
                    raise PhaseError(f"{name}: kernel {k} launched "
                                     f"{counts[k]} times, want {n}")
            if not all(np.isfinite(v) for v in res["results"].values()):
                raise PhaseError(f"{name}: non-finite results {cfg}")

            kw = dict(sparse_mode=modes, valid_offsets_map=vmap,
                      block_live_map=bmap, block_live_granularity=gran,
                      device="cuda")
            # built as eval3d.main builds its model (its compute type)
            model = eval3d.build_evaluator("eval_64k", variables, **kw)
            cfg["launches_by_core"] = tensor_core_check(name, model, counts)
            cfg["request_ms"] = spread(request_times(model, prof_batches,
                                                     SPARSE_REQUESTS))
            cfg["profile"] = profile_requests(model, prof_batches)
            cfg["sync"] = sync_count(name, lambda: serve.eval_step(
                model, prof_batches[0]))
            if how is not None:  # a = dense, b = this configuration
                cfg["wall_ms_in_turns"] = wall_in_turns(dense16, model,
                                                        prof_batches)
            with SparseRecorder() as rec:
                logits16 = serve.eval_step(model, batch)[0]
            if rec.k5:
                recs["k5"][name] = rec.k5
            if rec.k6:
                recs["k6"][name] = rec.k6
            del model
            model = eval3d.build_evaluator(
                "eval_64k", variables, compute_dtype=torch.float32, **kw)
            got = serve.eval_step(model, batch)[0]
            del model
            dense = eval3d.build_evaluator(
                "eval_64k", variables, device="cuda",
                compute_dtype=torch.float32)
            ref = serve.eval_step(dense, batch)[0]
            del dense
            torch.cuda.empty_cache()
            scale = float(ref[valid].abs().max())
            err = float((got[valid] - ref[valid]).abs().max())
            cfg["f32_vs_dense"] = {
                "max_abs_err": err, "max_abs_logit": scale,
                "err_of_max": err / scale,
                "argmax_agreement": float(
                    (got[valid].argmax(-1) == ref[valid].argmax(-1))
                    .float().mean())}
            gap = float((logits16[valid].float() - ref[valid]).abs().max())
            cfg["bf16_vs_dense_f32"] = {
                "max_abs_err": gap, "err_of_max": gap / scale,
                "argmax_agreement": float(
                    (logits16[valid].argmax(-1) == ref[valid].argmax(-1))
                    .float().mean())}
            if not (np.isfinite(err) and err <= SPARSE_TOL * scale):
                raise PhaseError(f"{name}: f32 logits off the dense model "
                                 f"on the same weights: {cfg}")
    line["overflow_check"] = overflow_check(dense16)
    return line, launches, recs


def k5_work(feats, starts, idx, w, live, block) -> tuple[int, int]:
    """(bytes, FLOPs) K5 must spend: the features, plan and liveness read
    once, the live weight blocks read once, the output written once;
    2 x (live channel pairs of the member) per present plan entry."""
    import torch

    g, nt, m, tile = idx.shape
    c, cout = w.shape[-2:]
    es = feats.element_size()
    nbi, nbo = live.shape[-2:]
    wi = torch.full((nbi,), float(block), device=w.device)
    wo = torch.full((nbo,), float(block), device=w.device)
    wi[-1], wo[-1] = c - block * (nbi - 1), cout - block * (nbo - 1)
    pairs = (live.double() * (wi[:, None] * wo[None, :]).double()).sum((2, 3))
    rows = starts[:, :, None, None].long() + idx.long()
    present = ((idx >= 0) & (rows < feats.shape[0])).sum((1, 3)).double()
    flops = int(2 * float((present * pairs).sum()))
    nbytes = (feats.numel() * es + int(float(pairs.sum())) * es
              + 4 * (idx.numel() + starts.numel()) + live.numel()
              + nt * tile * cout * es)
    return int(nbytes), flops


def k6_work(x_ext, km, w) -> tuple[int, int]:
    """(bytes, FLOPs) K6 must spend: x_ext, the kernel map and the weights
    read once, the f32 output written once; 2 Cin Cout operations per real
    pair (km < N_in)."""
    es = x_ext.element_size()
    c, cout = w.shape[-2:]
    pairs = int((km < x_ext.shape[0] - 1).sum())
    nbytes = ((x_ext.numel() + w.numel()) * es + 4 * km.numel()
              + 4 * km.shape[1] * cout)
    return int(nbytes), 2 * c * cout * pairs


def _dead_spec(live_shape, share: float, seed: int):
    """uint8 liveness with round(share x blocks) dead blocks per member."""
    import numpy as np
    import torch

    g, m, nbi, nbo = live_shape
    rng = np.random.default_rng(seed)
    n = nbi * nbo
    live = np.ones((g, m, n), np.uint8)
    for gi in range(g):
        for j in range(m):
            live[gi, j, rng.permutation(n)[:int(round(share * n))]] = 0
    return torch.as_tensor(live.reshape(live_shape))


def phase_k5(recs: dict) -> tuple[dict, dict]:
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        gather_matmul_bs,
        tc,
        window_gather_matmul,
        window_gather_matmul_bs,
        window_gather_matmul_bs_plain,
    )

    configs: dict = {}
    err32 = err16 = 0.0
    deterministic = True
    for name, calls in recs.items():
        acc = {"calls": len(calls), "ms": 0.0, "plain_ms": 0.0,
               "k2_masked_ms": 0.0, "bound_ms": 0.0, "bytes_bound_ms": 0.0,
               "shapes": {}}
        for feats, starts, idx, w, live, block in calls:
            c, cout = w.shape[-2:]
            g, nt, m, tile = idx.shape
            key = f"{feats.shape[0]}x{c}->{nt * tile}x{cout} G{g} M{m}"
            choice = tc.gather_choice(feats.dtype, nt * tile, c, cout, g * m)
            if choice.core != "tensor":
                raise PhaseError(f"K5 at {key} of the bf16 forward has "
                                 f"{feats.dtype} inputs")
            # the block tier keeps its weights zero on every dead block, so
            # the wrapper launches K5 alone (masked=True), as K2 is timed
            masked = (w * gather_matmul_bs.live_mask(live, block, c, cout)
                      .to(w.dtype)).contiguous()
            if not torch.equal(masked, w):
                raise PhaseError("K5 was given weights alive on dead blocks")
            f32, w32 = feats.float(), w.float()
            got = window_gather_matmul_bs(f32, starts, idx, w32, live, block,
                                          masked=True)
            want = window_gather_matmul_bs_plain(f32, starts, idx, w32, live,
                                                 block)
            d32 = (got - want).abs()
            bad32 = int((d32 > K2_F32_TOL + K2_F32_TOL * want.abs()).sum())
            got16 = window_gather_matmul_bs(feats, starts, idx, w, live,
                                            block, masked=True)
            d16 = (got16.float() - want).abs()
            bad16 = int((d16 > K2_BF16_ATOL + K2_BF16_RTOL
                         * want.abs()).sum())
            # K5 is K2's core with K2's tile and split, skipping only steps
            # that add exact zeros: equal to K2 on the masked weights, bit
            # for bit, in each type
            k2_32 = window_gather_matmul(f32, starts, idx, w32)
            k2 = window_gather_matmul(feats, starts, idx, masked)
            bad_k2 = {"f32": int((got != k2_32).sum()),
                      "bf16": int((got16 != k2).sum())}
            again = window_gather_matmul_bs(feats, starts, idx, w, live,
                                            block, masked=True)
            deterministic &= bool(torch.equal(again, got16))
            err32 = max(err32, float(d32.max()))
            err16 = max(err16, float(d16.max()))
            t_k = device_ms(lambda: window_gather_matmul_bs(
                feats, starts, idx, w, live, block, masked=True))
            t_k2 = device_ms(lambda: window_gather_matmul(feats, starts, idx,
                                                          masked))
            t_p = device_ms(lambda: window_gather_matmul_bs_plain(
                feats, starts, idx, w, live, block), reps=2)
            nbytes, flops = k5_work(feats, starts, idx, w, live, block)
            b, by = bound(nbytes, flops, feats.dtype)
            acc["ms"] += t_k
            acc["plain_ms"] += t_p
            acc["k2_masked_ms"] += t_k2
            acc["bound_ms"] += b
            acc["bytes_bound_ms"] += b if by == "bytes" else 0.0
            s = acc["shapes"].setdefault(key, {
                "calls": 0, "block": block, "dead_share": 0.0,
                "core": choice.describe(),
                "live_step_share": gather_matmul_bs.live_step_share(
                    live, block, c, cout, choice.column_tile),
                "ms": 0.0, "k2_masked_ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "bound_by": by})
            s["calls"] += 1
            s["dead_share"] = 1.0 - float(live.float().mean())
            s["ms"] += t_k
            s["k2_masked_ms"] += t_k2
            s["plain_ms"] += t_p
            s["bound_ms"] += b
            s["roofline_share"] = s["bound_ms"] / s["ms"]
            s["k5_over_k2"] = s["ms"] / s["k2_masked_ms"]
            if bad32 or bad16 or any(bad_k2.values()):
                raise PhaseError(f"K5 outside tolerance at {key}: {bad32} "
                                 f"f32, {bad16} bf16 elements; differing "
                                 f"from K2 on the masked weights {bad_k2}")
        acc["roofline_share"] = acc["bound_ms"] / acc["ms"]
        configs[name] = acc
    if not deterministic:
        raise PhaseError("K5: two launches on the same inputs differ")

    # the dead-block crossover: K5 against K2 on the spec-masked weights,
    # same plans, same inputs, timed in turns (K2, K5, K5, K2)
    crossover = []
    calls32 = recs.get("blocks32_csr", [])
    calls128 = recs.get("blocks128_csr", [])
    picks = []
    if calls32:  # the finest level's call, and the widest matrix's
        picks.append((max(calls32, key=lambda a: a[0].shape[0]), 32))
        picks.append((max(calls32, key=lambda a: a[3].shape[-2]
                          * a[3].shape[-1]), 32))
    if calls128:  # the matrix with the most 128-blocks
        picks.append((max(calls128, key=lambda a: a[4].shape[-2]
                          * a[4].shape[-1]), 128))
    for (feats, starts, idx, w, live, _), block in picks:
        c, cout = w.shape[-2:]
        for share in K5_DEAD_SHARES:
            spec = _dead_spec(live.shape[:2] + (-(-c // block),
                                                -(-cout // block)),
                              share, 7).to(live.device)
            masked = (w * gather_matmul_bs.live_mask(spec, block, c, cout)
                      .to(w.dtype)).contiguous()
            t = {"k2": [], "k5": []}
            for which in ("k2", "k5", "k5", "k2"):
                if which == "k2":
                    t["k2"].append(device_ms(lambda: window_gather_matmul(
                        feats, starts, idx, masked)))
                else:
                    t["k5"].append(device_ms(lambda: window_gather_matmul_bs(
                        feats, starts, idx, masked, spec, block, masked=True)))
            k2_ms, k5_ms = (sum(v) / len(v) for v in (t["k2"], t["k5"]))
            crossover.append({
                "rows": idx.shape[1] * idx.shape[3], "C": c, "Cout": cout,
                "block": block, "dead_share": 1.0 - float(spec.float()
                                                          .mean()),
                "live_step_share": gather_matmul_bs.live_step_share(
                    spec, block, c, cout, tc.column_tile(c, cout)),
                "k2_ms": k2_ms, "k5_ms": k5_ms, "k5_over_k2": k5_ms / k2_ms})
    head = configs.get("blocks32_csr") or next(iter(configs.values()))
    line = {"phase": "k5", "configs": configs, "crossover": crossover,
            "max_abs_err_f32": err32, "max_abs_err_bf16": err16,
            "equal_to_k2": {"f32": True, "bf16": True},
            "deterministic": deterministic,
            "tolerance": {"f32": [K2_F32_TOL, K2_F32_TOL],
                          "bf16": [K2_BF16_ATOL, K2_BF16_RTOL]}}
    return line, {"max_abs_err": err32, "max_abs_err_bf16": err16,
                  "equal_to_k2_on_masked_weights": True,
                  "core": "tensor cores (bf16), CUDA cores (f32)",
                  "deterministic": deterministic, "ms": head["ms"],
                  "plain_ms": head["plain_ms"],
                  "k2_masked_ms": head["k2_masked_ms"],
                  "bound_ms": head["bound_ms"],
                  "bound_by": ("bytes" if head["bytes_bound_ms"]
                               >= head["bound_ms"] / 2 else "operations"),
                  "calls_per_forward": head["calls"]}


def phase_k6(recs: dict) -> tuple[dict, dict]:
    """Every K6 call of the recorded ZAXIS and strided forwards (each with
    bf16 inputs, so on the tensor cores) against its plain version: in f32
    (CUDA cores) and in bf16 within 1e-5 x (1 + the sum of absolute
    products) of the f32 sum (``k6_bad``); two
    bf16 launches bit-identical. Per call: the core, column tile and step
    split, the time beside the bound, the plain version and, for
    information, an im2col (``x_ext[km.T]``) plus one ``torch.matmul``,
    which the port never calls. Also the ptxas lines of K2, K3 and K5,
    whose core K6's now shares."""
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        build,
        row_gather_matmul,
        row_gather_matmul_plain,
        tc,
    )

    configs: dict = {}
    err32 = err16 = 0.0
    deterministic = True
    for name, calls in recs.items():
        acc = {"calls": [], "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "im2col_matmul_ms": 0.0, "bytes_bound_ms": 0.0}
        for x_ext, km, w in calls:
            if {x_ext.dtype, w.dtype} != {torch.bfloat16}:
                raise PhaseError(f"K6 call of the bf16 {name} forward with "
                                 f"{x_ext.dtype} inputs")
            k, n_out = km.shape
            c, cout = w.shape[-2:]
            choice = tc.row_choice(x_ext.dtype, n_out, c, cout, k,
                                   tc.aligned(x_ext, w))
            if choice.core != "tensor":
                raise PhaseError(f"K6 of the {name} forward is not on the "
                                 "tensor cores")
            want = row_gather_matmul_plain(x_ext.float(), km, w.float())
            errs = {}
            for dt, (x, ww) in (("f32", (x_ext.float(), w.float())),
                                ("bf16", (x_ext, w))):
                got = row_gather_matmul(x, km, ww)
                bad = k6_bad(x_ext, km, w, got, want)
                errs[dt] = float((got - want).abs().max())
                if bad:
                    raise PhaseError(f"K6 ({dt}) outside tolerance: {bad} "
                                     f"elements, K={k}")
                if dt == "bf16":
                    deterministic &= bool(torch.equal(
                        row_gather_matmul(x, km, ww), got))
            err32, err16 = max(err32, errs["f32"]), max(err16, errs["bf16"])
            cols = km.t().long().contiguous()
            wm = w.reshape(k * c, cout)
            t_k = device_ms(lambda: row_gather_matmul(x_ext, km, w))
            t_p = device_ms(lambda: row_gather_matmul_plain(x_ext, km, w),
                            reps=2)
            t_c = device_ms(lambda: torch.matmul(
                x_ext[cols].reshape(n_out, k * c), wm), reps=2)
            nbytes, flops = k6_work(x_ext, km, w)
            b, by = bound(nbytes, flops, x_ext.dtype)
            acc["ms"] += t_k
            acc["plain_ms"] += t_p
            acc["im2col_matmul_ms"] += t_c
            acc["bound_ms"] += b
            acc["bytes_bound_ms"] += b if by == "bytes" else 0.0
            acc["calls"].append({
                "K": k, "n_in": x_ext.shape[0] - 1, "n_out": n_out, "C": c,
                "Cout": cout, "pairs": int((km < x_ext.shape[0] - 1).sum()),
                "core": choice.describe_steps(), "ms": t_k, "plain_ms": t_p,
                "im2col_matmul_ms": t_c, "bound_ms": b, "bound_by": by,
                "roofline_share": b / t_k, "max_abs_err": errs})
        configs[name] = acc
    if not deterministic:
        raise PhaseError("K6: two launches on the same inputs differ")
    # per source, each kernel's lines, sorted (the order in which nvcc
    # emits the kernels is not the code)
    ptxas = {stem: sorted(" | ".join(v) for v in ptxas_by_kernel(log)
                          .values())
             for stem, log in build.ptxas_report().items()
             if stem in ("window_gather_matmul", "window_bwd",
                         "window_gather_matmul_bs", "row_gather_matmul")}
    head = configs.get("zaxis") or next(iter(configs.values()))
    line = {"phase": "k6", "configs": configs, "max_abs_err_f32": err32,
            "max_abs_err_bf16_inputs": err16,
            "deterministic": deterministic, "ptxas": ptxas,
            "tolerance": f"{K2_F32_TOL} x (1 + sum |x| |w|)"}
    return line, {"max_abs_err": err32, "max_abs_err_bf16_inputs": err16,
                  "deterministic": deterministic, "ms": head["ms"],
                  "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                  "im2col_matmul_ms": head["im2col_matmul_ms"],
                  "bound_by": ("bytes" if head["bytes_bound_ms"]
                               >= head["bound_ms"] / 2 else "operations"),
                  "core": "tensor cores (bf16), CUDA cores (f32)",
                  "calls_per_forward": len(head["calls"])}


# -- the evaluation CLI, ScanNet over PLY, and the other norms ----------------

CLI_EVAL_TOL = 1e-5  # relative: the eval CLI against the logged validation
# pruned copies of cli_train's best checkpoint: (name, pruning, flags)
CLI_EVAL_SPARSE = (
    ("zaxis", "zaxis", ["--sparsify", "--sparse_mode", TWOS]),
    ("blocks32_csr", 32, ["--sparsify", "--sparse_mode", ONES, "--layout",
                          "csr", "--ginb",
                          "CoordinateContext.block_live_granularity = 32"]),
)
# the ScanNet rooms of phase cli_semseg (data.synthetic.
# write_scannet_ply_tree): 16 train rooms (2 batches of 8 per epoch), 4 val
# rooms (2 batches of 2), 100,000 vertices each, floor sides 2.5-3.2 m,
# turned 20-70 degrees about z, smaller than ScanNet's rooms of up to
# 7.5 m: the config as written does not run on larger or axis-aligned
# rooms (ROADMAP Queue 3). Its augmentation (rotation, a 5 m crop, an
# affine of scale up to 1.2 with shear) takes larger rooms past its
# grid_extent of 384 voxels now and then, where collate_mink raises; and
# a wall parallel to the y-z plane puts its whole face (about 20,000
# rows) in one x-slice of the sorted keys, beyond any window coverage
# the calibration offers (it refused windows of 128, 256 and 512)
SEMSEG_TREE = dict(n_train=16, n_val=4, n_vertices=100_000,
                   extent=(2.5, 3.2), yaw=(20.0, 70.0))
SEMSEG_STEPS, SEMSEG_VAL_AT = 6, 5
# bound beside the data root and the cadence: at the config's window of
# 128 (unbound) the calibration finds no coverage for these rooms and
# refuses the run (ROADMAP Queue 3)
SEMSEG_WINDOW = 256
NORM_TYPES = ("IN", "LN", "PN")
TRACE_KERNEL = "window_match_kernel"  # K1's kernel, in every --profile
NORM_TOL = 1e-4  # of max|logit|: the kernel path against the CPU plain path
NORM_STEP_TOL = 1e-5  # of each leaf's largest entry
# of each ema_gz leaf's largest, a PN step on the card against the CPU's
# (a mean over 62,400 rows whose terms cancel): tools/pn_step_spread.py
# over seeds 0-3 measured at most 1.34e-2 (the first step) and 6.4e-3
# (the second), and at least 1.22 for the control without the EMA
# correction
PN_EMA_TOL = 5e-2


class EvalProbe:
    """Wraps ``Trainer.validate``: keeps the (trainer, state) of the last
    validation."""

    def __enter__(self):
        from nerf_downstream_tpu_torch.train import loop

        probe = self
        self.last = None
        self._saved = loop.Trainer.validate
        validate = self._saved

        def wrapped(trainer, state, phase="val"):
            probe.last = (trainer, state)
            return validate(trainer, state, phase)

        loop.Trainer.validate = wrapped
        return self

    def __exit__(self, *exc):
        from nerf_downstream_tpu_torch.train import loop

        loop.Trainer.validate = self._saved
        return False


def run_eval_cli(args: list, device: str = "cuda"):
    """``co3d_3d.eval.main(args)`` from a clear configuration, its stdout
    captured: (results or None, stdout, (trainer, state) of its
    validation)."""
    import contextlib
    import io

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.co3d_3d import eval as ecli

    out = io.StringIO()
    gin.clear_config()
    with EvalProbe() as probe, contextlib.redirect_stdout(out):
        res = ecli.main(args + ["--device", device])
    return res, out.getvalue(), probe.last


def held_to(where: str, got: dict, want: dict, keys) -> dict:
    """The relative gaps of ``keys`` between the eval CLI's results and
    the logged validation; raises beyond ``CLI_EVAL_TOL``."""
    import numpy as np

    gaps = {}
    for k in keys:
        a, b = float(got[k]), float(want[k])
        gaps[k] = abs(a - b) / max(abs(b), 1e-12)
        if not (np.isfinite(a) and (a == b or gaps[k] <= CLI_EVAL_TOL)):
            raise PhaseError(f"{where}: {k} {a} against the logged {b}")
    return gaps


def eval_batch_costs(where: str, trainer, state, device: str = "cuda"):
    """One validation batch of ``trainer``'s data through its task's eval
    step: synchronising calls, a profile (device time, ops) and the host
    wall ms of the step with a synchronise on either side."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_downstream_tpu_torch.train.loop import to_device

    batch = to_device(next(iter(trainer.datamodule.val_batches())), device)
    task = trainer.task

    def step():
        task.eval_step(state, batch)

    step()
    sync = sync_count(where, step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        step()
        torch.cuda.synchronize()
    rows = device_rows(p, 1)
    dev_ms = sum(r[0] for r in rows)
    if dev_ms <= 0:
        raise PhaseError(f"{where}: the profiler saw no device time")
    return {"rows": int(batch["mask"].sum()),
            "capacity": int(batch["mask"].shape[0]),
            "wall_ms_per_batch": wall, "device_ms_per_batch": dev_ms,
            "device_busy_share": dev_ms / wall,
            "device_ops_per_batch": sum(r[1] for r in rows), "sync": sync}


def phase_cli_eval(card: str, kept: dict,
                   device: str = "cuda") -> tuple[dict, dict]:
    """The port's evaluation CLI (``co3d_3d.eval``) on the checkpoints
    phases ``cli_train`` and ``cli_cls`` wrote, on their trees, with their
    gin files and arguments (the classification run's pinned knobs) and
    the validation batch size of their runs (``evaluate.val_batch_size``):

    - ``best.ckpt`` of ``cli_train``: ``val/mIoU``, ``val/OA`` and
      ``val/loss`` equal, within ``CLI_EVAL_TOL`` relative, to what the
      run's test pass logged for that checkpoint;
    - the same checkpoint pruned as ``phase_sparse_eval`` prunes, under
      ``--sparsify`` ZAXIS and csr at granularity 32: the routes and the
      K6 and K5 launches as ``sparse_eval`` requires them, and the results
      beside the dense CLI's on the same zeroed weights;
    - ``best.ckpt`` of ``cli_cls`` with ``--training_module
      ClassificationTraining``: ``val/acc1``, ``val/acc5`` and
      ``val/loss`` equal to the logged validation within the same bound;
    - ``--visualize`` writes ``.npz`` files, ``--profile`` a trace that
      holds the kernels' names, and a call on an existing tag skips.

    Launch counts are reset before each CLI run and summed. Per run: the
    CLI's wall seconds and ``val/iter_time``; for one validation batch of
    each task its synchronising calls, device time, busy share and device
    ops. Removes the kept trees. ``device`` serves a rehearsal on the
    CPU."""
    import contextlib
    import glob
    import io
    import shutil

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import eval3d
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.train.checkpoints import (
        load_checkpoint,
        save_checkpoint,
    )

    seg, cls = kept["cli_train"], kept["cli_cls"]
    launches = {name: 0 for name in kernels.launch_counts()}
    line = {"phase": "cli_eval", "card": card, "entry":
            "python -m nerf_downstream_tpu_torch.co3d_3d.eval",
            "tolerance_relative": CLI_EVAL_TOL, "runs": {}}

    def run(name, args, **check):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res, text, last = run_eval_cli(args, device)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for k, v in counts.items():
            launches[k] += v
        entry = {"seconds": time.perf_counter() - t0, "results": res,
                 "launches": counts,
                 "num_params_line": [ln for ln in text.splitlines()
                                     if ln.startswith("num_params")]}
        line["runs"][name] = entry
        if res is not None and not all(np.isfinite(v)
                                       for v in res.values()):
            raise PhaseError(f"cli_eval {name}: non-finite results {entry}")
        return res, text, last, entry

    try:
        out = os.path.join(seg["tmp"], "eval")
        sbase = seg["args"] + ["--ginb", "evaluate.val_batch_size = "
                               f"{seg['val_batch_size']}", "--save_path",
                               out]
        best = os.path.join(seg["save"], "best.ckpt")
        res, text, (trainer, state), entry = run(
            "seg", sbase + ["--load_path", best, "--tag", "seg"])
        entry["logged"] = seg["val"][-1]
        entry["relative_gaps"] = held_to(
            "cli_eval seg", res, seg["val"][-1],
            ("val/mIoU", "val/OA", "val/loss"))
        entry["batch"] = eval_batch_costs("cli_eval seg", trainer, state,
                                          device)
        for k in WINDOW_KERNELS:
            if entry["launches"][k] <= 0:
                raise PhaseError(f"cli_eval seg: kernel {k} never launched")
        n_val = len(list(trainer.datamodule.val_batches()))
        del trainer, state

        raw = load_checkpoint(best)
        for name, how, flags in CLI_EVAL_SPARSE:
            params = pruned_params(raw["params"], how)
            ckpt = os.path.join(seg["tmp"], name, "best.ckpt")
            save_checkpoint(ckpt, params, raw["batch_stats"])
            dense, _, _, dense_entry = run(
                f"{name}_dense", sbase + ["--load_path", ckpt, "--tag",
                                          f"{name}_dense"])
            res, _, (trainer, state), entry = run(
                name, sbase + ["--load_path", ckpt, "--tag", name, *flags])
            model = state.model
            blocks = isinstance(how, int)  # else ZAXIS
            with contextlib.redirect_stdout(io.StringIO()):
                vmap, bmap = eval3d.derive_maps(
                    params, [1 if blocks else 2] * 9,
                    "csr" if blocks else "strided", how if blocks else 128)
            routes = eval3d.route_counts(model)
            total = sum(routes.values())
            down = {f"conv{i}_conv" for i in range(1, 5)}
            n_row = 4 if how == "zaxis" else len(down & set(vmap or {}))
            n_bs = len([p for p in (bmap or {}) if not p.startswith("convtr")])
            want = {"windowed": total - n_row - n_bs, "row": n_row,
                    "blocksparse": n_bs}
            want = {k: v for k, v in want.items() if v}
            entry.update(routes=routes, val_batches=n_val,
                         offset_map_entries=len(vmap or {}),
                         block_map_entries=len(bmap or {}),
                         dense_results=dense,
                         relative_gaps_to_dense={
                             k: abs(res[k] - dense[k]) / max(abs(dense[k]),
                                                             1e-12)
                             for k in ("val/mIoU", "val/OA", "val/loss")})
            if routes != want:
                raise PhaseError(f"cli_eval {name}: routes {routes}, want "
                                 f"{want}")
            want_k = {"window_gather_matmul_bs": n_bs * n_val,
                      "row_gather_matmul": n_row * n_val}
            path_kernel = ("window_gather_matmul_bs" if blocks
                           else "row_gather_matmul")
            for k, n in want_k.items():
                if entry["launches"][k] != n or want_k[path_kernel] == 0:
                    raise PhaseError(f"cli_eval {name}: {k} launched "
                                     f"{entry['launches'][k]} times, want "
                                     f"{n}; {path_kernel} must launch")
            del trainer, state, model
            torch.cuda.empty_cache()

        cout = os.path.join(cls["tmp"], "eval")
        cbase = cls["args"] + [
            "--ginb", f"evaluate.val_batch_size = {cls['val_batch_size']}",
            "--training_module", "ClassificationTraining",
            "--save_path", cout]
        res, _, (trainer, state), entry = run(
            "cls", cbase + ["--load_path", os.path.join(cls["save"],
                                                        "best.ckpt"),
                            "--tag", "cls"])
        entry["logged"] = cls["val"][-1]
        entry["relative_gaps"] = held_to(
            "cli_eval cls", res, cls["val"][-1],
            ("val/acc1", "val/acc5", "val/loss"))
        entry["batch"] = eval_batch_costs("cli_eval cls", trainer, state,
                                          device)
        del trainer, state

        res, _, _, entry = run("visualize", sbase + [
            "--load_path", best, "--tag", "vis", "--visualize"])
        npz = glob.glob(os.path.join(out, "figure", "vis", "*.npz"))
        entry["npz_files"] = len(npz)
        if not npz:
            raise PhaseError("cli_eval: --visualize wrote no .npz file")
        res, _, _, entry = run("profile", sbase + [
            "--load_path", best, "--tag", "prof", "--profile"])
        trace = os.path.join(out, "trace", "trace.json")
        text = open(trace).read() if os.path.exists(trace) else ""
        entry["trace_bytes"] = len(text)
        entry["trace_names_the_kernels"] = TRACE_KERNEL in text
        if not entry["trace_names_the_kernels"]:
            raise PhaseError("cli_eval: --profile wrote no trace of the "
                             "kernels")
        res, text, _, entry = run("skip", sbase + ["--load_path", best,
                                                   "--tag", "seg"])
        entry["skipped"] = res is None and "skip existing" in text
        if not entry["skipped"]:
            raise PhaseError("cli_eval: an existing tag was not skipped")
        line["launches"] = launches
        return line, launches
    finally:
        for k in ("cli_train", "cli_cls"):
            shutil.rmtree(kept.get(k, {}).get("tmp", ""), ignore_errors=True)


def k4_step(where: str, calls) -> dict:
    """One step's K4 calls against the plain version (d_w within DW_TOL
    of each (g, m)'s largest), summed: device ms, the plain version's ms,
    the bound and its share, with the shapes and the core."""
    import torch

    from nerf_downstream_tpu_torch.ops.kernels import (
        tc,
        window_dw,
        window_dw_plain,
    )

    if not calls:
        raise PhaseError(f"{where}: the step made no K4 call")
    _finite_nonzero(where, "K4", [a[3] for a in calls])
    out = {"calls": len(calls), "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "worst_of_max": 0.0, "shapes": []}
    for args in calls:
        rel, _ = dw_err(window_dw(*args), window_dw_plain(*args))
        if not rel <= DW_TOL:
            raise PhaseError(f"{where}: K4 off its plain version ({rel})")
        feats, _, idx, g_out = args
        b, out["bound_by"] = bound(*k4_work(*args), feats.dtype)
        out["bound_ms"] += b
        out["ms"] += device_ms(lambda: window_dw(*args))
        out["plain_ms"] += device_ms(lambda: window_dw_plain(*args), reps=1)
        out["worst_of_max"] = max(out["worst_of_max"], rel)
        g, nt, m, tile = idx.shape
        out["shapes"].append({"C": feats.shape[1], "Cout": g_out.shape[1],
                              "rows": nt * tile, "G": g, "M": m,
                              "core": tc.dw_choice(
                                  feats.dtype, nt * tile, feats.shape[1],
                                  g_out.shape[1], g * m).describe(nt * tile)})
    out["roofline_share"] = out["bound_ms"] / out["ms"]
    return out


def k3_dw_work(c3) -> tuple[int, int]:
    """(bytes, FLOPs) of K3's d_w half alone: ``k3_work``'s terms for d_w
    (feats and g_out read once, the inverse plan read once, d_w (f32)
    written once; 2 C Cout operations per present entry)."""
    g_out, feats = c3["g_out"], c3["feats"]
    es = g_out.element_size()
    g, _, m, _ = c3["inv_idx"].shape
    c, cout = feats.shape[1], g_out.shape[1]
    nbytes = (es * (g_out.numel() + feats.numel())
              + 4 * (c3["inv_idx"].numel() + c3["inv_starts"].numel())
              + 4 * g * m * c * cout)
    present = present_entries(c3["inv_starts"], c3["inv_idx"],
                              g_out.shape[0])
    return int(nbytes), 2 * c * cout * present


def k3_dw_step(where: str, calls) -> dict:
    """One step's K3 calls: each d_w against its plain version within
    ``K2_F32_TOL`` x (1 + the sum of the absolute products) of each entry
    (the f32 bound ``k6_bad`` applies: at ``cli_semseg``'s 2,097,152 rows
    the two summation orders part by up to 2e-4 of a slice's largest
    entry, past phase k3's DW_TOL for 65,536 rows, which is reported as
    ``worst_of_max``), and the device time of its d_w half beside that
    half's bound (``k3_dw_work``), summed: the whole call's time less its
    d_feats half's (K2's wrapper on the inverse plan, as phase k3 times
    it; CUDA events). (A profile of one call alone saw 1 % of that time,
    where the step's profile sees all of it.)"""
    from nerf_downstream_tpu_torch.ops.kernels import (
        window_bwd,
        window_bwd_plain,
        window_gather_matmul,
    )

    if not calls:
        raise PhaseError(f"{where}: the step made no K3 call")
    out = {"calls": len(calls), "ms": 0.0, "d_feats_ms": 0.0,
           "bound_ms": 0.0, "worst_of_max": 0.0, "dtypes": set()}
    for c3 in calls:
        args = [c3[k] for k in ("g_out", "feats", "inv_starts", "inv_idx",
                                "w_t")]
        got, want = window_bwd(*args)[1], window_bwd_plain(*args)[1]
        rel, _ = dw_err(got, want)
        scale = window_bwd_plain(*[a.abs() if a.is_floating_point() else a
                                   for a in args])[1]
        bad = int(((got - want).abs() > K2_F32_TOL * (1 + scale)).sum())
        if bad or not rel == rel:
            raise PhaseError(f"{where}: K3's d_w off its plain version "
                             f"({bad} entries; {rel} of a slice's largest)")
        out["worst_of_max"] = max(out["worst_of_max"], rel)
        out["ms"] += device_ms(lambda: window_bwd(*args), reps=2)
        out["d_feats_ms"] += device_ms(lambda: window_gather_matmul(
            args[0], args[2], args[3], args[4]), reps=2)
        b, out["bound_by"] = bound(*k3_dw_work(c3), args[0].dtype)
        out["bound_ms"] += b
        out["dtypes"].add(str(args[0].dtype))
    out["dw_ms"] = out["ms"] - out["d_feats_ms"]
    if out["dw_ms"] <= 0:
        raise PhaseError(f"{where}: K3's d_w half took no time: {out}")
    out["dtypes"] = sorted(out["dtypes"])
    out["roofline_share"] = out["bound_ms"] / out["dw_ms"]
    return out


def phase_cli_semseg(card: str, device: str = "cuda",
                     bindings=()) -> tuple[dict, dict]:
    """``scannet_semseg.gin`` unchanged through the port's training CLI:
    Res16UNet at its factory widths (32-96 planes, 2 blocks per stage), 3
    colour channels, 20 classes, batch 8, val batch 2, SGD with PolyLR,
    the config's host augmentation list with ``ElasticDistortion``, f32
    and the automatic calibration (timed), on ScanNet rooms the port
    writes as binary PLY (``SEMSEG_TREE``); only the data root,
    ``max_steps``, the validation cadence (one pass, after step
    ``SEMSEG_VAL_AT``), the worker counts (the config's 8 and 4) and, a
    deviation from the config, ``CoordinateContext.window_size =
    SEMSEG_WINDOW`` are bound (at the config's 128 the calibration finds
    no coverage for these rooms and refuses the run). Then
    ``co3d_3d.eval`` on its ``best.ckpt`` with the calibrated
    knobs pinned: ``val/mIoU``, ``val/OA`` and ``val/loss`` equal to the
    logged validation within ``CLI_EVAL_TOL`` relative. Launch counts are
    reset before the training run and read after the eval. Fails unless
    the losses are finite, ``val/mIoU`` is logged and K1-K4 launched.
    Reports the rooms' voxel counts, the batch capacity, the step wall
    median after the first, the calibration's seconds, ms per validation
    pass, host ms per batch (one worker; waited with 8), and for one more
    step its synchronising calls, device time, busy share and ops, its K4
    calls held against the plain version and timed beside their bound
    (``k4_step``), and its K3 calls held against the plain version with
    their d_w half timed beside that half's bound (``k3_dw_step``)."""
    import contextlib
    import csv
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.co3d_3d import train as cli
    from nerf_downstream_tpu_torch.data.data_module import DataModule
    from nerf_downstream_tpu_torch.data.synthetic import (
        write_scannet_ply_tree,
    )
    from nerf_downstream_tpu_torch.models.mink.layers import (
        SparseConv,
        SparseConvTranspose,
    )
    from nerf_downstream_tpu_torch.ops import kernels
    from nerf_downstream_tpu_torch.utils import calibrate as calib

    tmp = tempfile.mkdtemp(prefix="cli_semseg_")
    scan = calib.maybe_auto_calibrate
    scans = []

    def timed_scan(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scan(*a, **kw)
        torch.cuda.synchronize()
        scans.append({"seconds": time.perf_counter() - t0, "bound": out})
        return out

    try:
        t0 = time.perf_counter()
        root = write_scannet_ply_tree(tmp, np.random.default_rng(0),
                                      **SEMSEG_TREE)
        tree_s = time.perf_counter() - t0
        save = os.path.join(tmp, "exp")
        config = os.path.join(REPO, "co3d_3d", "configs",
                              "scannet_semseg.gin")
        args = ["--ginc", config]
        for b in (f'ScannetDataset.data_root = "{root}"',
                  f"train.max_steps = {SEMSEG_STEPS}",
                  f"train.val_every_n_steps = {SEMSEG_VAL_AT}",
                  "train.train_num_workers = 8", "train.val_num_workers = 4",
                  f"CoordinateContext.window_size = {SEMSEG_WINDOW}",
                  *bindings):
            args += ["--ginb", b]
        stdout = io.StringIO()
        calib.maybe_auto_calibrate = timed_scan
        gin.clear_config()
        with CliProbe() as probe, contextlib.redirect_stdout(stdout):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(args + ["--save_path", save, "--seed", "0", "--device",
                             device])
            run_s = time.perf_counter() - t0
            calib.maybe_auto_calibrate = scan
            bound = {k: gin.query_parameter(f"CoordinateContext.{k}",
                                            default=None)
                     for k in ("level_caps", "window_escape_cap",
                               "window_escape_tiles", "window_blocks",
                               "window_cross_blocks", "window_expand_factor",
                               "window_tile", "window_size")}
            knobs = [a for k, v in bound.items() if v is not None
                     for a in ("--ginb", f"CoordinateContext.{k} = {v!r}")]
        task, state, batch = probe.last
        with open(os.path.join(save, "b8x1-Res16UNet", "metrics.csv")) as f:
            logged = list(csv.DictReader(f))
        train_losses = probe.losses  # the config logs every 10th step
        val = [{k: float(r[k]) for k in ("step", "val/loss", "val/mIoU",
                                         "val/OA")}
               for r in logged if r.get("val/mIoU")]
        types = {m.compute_dtype for m in task.model.modules()
                 if isinstance(m, (SparseConv, SparseConvTranspose))}
        ms = [m for _, m in probe.steps]
        prof = probe.profilers[-1]
        rooms = []
        ds = task.datamodule.dataset("val")
        for i in range(len(ds)):
            c = ds[i]["coordinates"]
            rooms.append(int(np.unique(np.floor(c), axis=0).shape[0]))
        line = {
            "phase": "cli_semseg", "card": card, "entry":
            "python -m nerf_downstream_tpu_torch.co3d_3d.train",
            "config": "co3d_3d/configs/scannet_semseg.gin",
            "model": type(task.model).__name__,
            "planes": list(task.model.planes),
            "layers": list(task.model.layers),
            "tree": dict(SEMSEG_TREE, seconds=tree_s),
            "dtype": "float32 (the config binds no compute type)",
            "capacity": int(batch["mask"].shape[0]),
            "valid_finest_rows": probe.rows,
            "val_room_voxels": rooms,
            "automatic_calibration": scans,
            "window_size_bound": SEMSEG_WINDOW,
            "steps": [s for s, _ in probe.steps], "ms": ms,
            "ms_median_after_first": float(np.median(ms[1:])),
            "run_seconds": run_s, "train_losses": train_losses, "val": val,
            "val_pass_ms": probe.val_ms,
            "host_ms_per_batch_waited": prof.recorded_time(
                "get_train_batch") * 1e3,
        }
        ok = (np.isfinite(train_losses).all() and len(train_losses) > 0
              and len(val) == 1 and np.isfinite(val[0]["val/loss"])
              and types == {torch.float32}
              and [c["bound"] for c in scans] == [True])
        if not ok:
            raise PhaseError(f"cli_semseg: {line}")
        res, _, _ = run_eval_cli(args + knobs + [
            "--ginb", "evaluate.val_batch_size = 2", "--load_path",
            os.path.join(save, "best.ckpt"), "--tag", "semseg",
            "--save_path", os.path.join(tmp, "eval")], device)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        line["eval"] = {"results": res, "relative_gaps": held_to(
            "cli_semseg", res, val[0], ("val/mIoU", "val/OA", "val/loss"))}
        line["launches"] = counts
        for k in CLI_KERNELS:
            if counts[k] <= 0:
                raise PhaseError(f"cli_semseg: kernel {k} never launched")
        dm = DataModule(batch_size=8, val_batch_size=2, train_num_workers=1,
                        capacity=line["capacity"])
        state.step = 0  # PolyLR is undefined past max_steps
        rec = cli_extra_steps("cli_semseg", line, task, state, batch, dm,
                              TrainRecorder, 2)
        line["k4_per_step"] = k4_step("cli_semseg", rec.k4)
        line["k3_dw_per_step"] = k3_dw_step("cli_semseg", rec.k3)
        return line, counts
    finally:
        calib.maybe_auto_calibrate = scan
        gin.clear_config()
        shutil.rmtree(tmp, ignore_errors=True)


def norm_model(norm_type: str, device, variables=None, seed: int = 3):
    """Res16UNet18A at full width, f32, with the eval_64k window knobs and
    ``norm_type`` norms over 8 scenes, on ``device``; weights from
    ``variables`` (drawn from ``seed`` with every norm away from identity
    when None; PowerNorm's ``ema_gz`` then 0, as a fresh or converted
    model's)."""
    import torch

    from nerf_downstream_tpu_torch import convert, serve
    from nerf_downstream_tpu_torch.models import get_model

    p = serve.PRESETS["eval_64k"]
    model = get_model("Res16UNet18A", in_channel=serve.IN_CHANNELS,
                      out_channel=serve.NUM_CLASSES,
                      compute_dtype=torch.float32,
                      ctx=dict(p["ctx"], grid_extent=p["grid_extent"]),
                      assume_unique=p["assume_unique"],
                      norm_type=norm_type, num_batches=p["scenes"])
    if variables is None:
        variables = convert.init_flax_variables(model, seed)
        if "batch_stats" in variables:  # IN and LN keep no statistics
            variables["batch_stats"] = _zero_ema(variables["batch_stats"])
    convert.load_flax_variables(model, variables)
    return model.to(device), variables


def _zero_ema(tree: dict) -> dict:
    """``tree`` with every ``ema_gz`` leaf 0."""
    import numpy as np

    return {k: (_zero_ema(v) if isinstance(v, dict)
                else np.zeros_like(v) if k == "ema_gz" else v)
            for k, v in tree.items()}


def step_gaps(after: dict, cafter: dict, iters: int) -> dict:
    """{kind: (its worst leaf, max gap / the CPU leaf's largest entry)}
    of a card state against the CPU's after a training step, kinds
    ``running_phi``, ``ema_gz`` and ``weights`` (every other leaf), with
    the ten worst weights; ``iters`` must be ``iters`` on both sides."""
    kinds: dict = {"running_phi": {}, "ema_gz": {}, "weights": {}}
    for k, v in cafter.items():
        a = after[k].cpu()
        if k.endswith("iters"):
            if int(a) != int(v) or int(v) != iters:
                raise PhaseError(f"norms PN: {k} {int(a)}, {int(v)}")
            continue
        leaf = k.rsplit(".", 1)[-1]
        kinds[leaf if leaf in kinds else "weights"][k] = (
            float((a - v).abs().max()) / max(float(v.abs().max()), 1e-30))
    out = {n: max(d.items(), key=lambda kv: kv[1]) for n, d in kinds.items()
           if d}
    out["worst_10_weights"] = sorted(kinds["weights"].items(),
                                     key=lambda kv: -kv[1])[:10]
    return out


def bn_step_worst(gpu, cpu, batch: dict) -> tuple[str, float]:
    """The worst leaf gap (``step_gaps``) of one BatchNorm training step
    on the card against the CPU's from the same state: how far the
    kernels' and the plain versions' summation orders alone move a
    step (no PowerNorm code in it)."""
    _, _, after = norm_step(gpu, batch["cuda"])
    _, _, cafter = norm_step(cpu, batch["cpu"])
    return step_gaps(after, cafter, 0)["weights"]


def pn_steps(gpu, cpu, batch: dict) -> dict:
    """Two PowerNorm training steps of the whole model, on the card and on
    the CPU, each from the same state: the first from the models' state
    (``ema_gz`` 0, where the backward's correction ``-(1 - abkw) *
    ema_gz * z`` is 0), the second from the CPU's state after the first
    (``ema_gz`` nonzero, the correction at work). Returns the first
    step's loss on both sides, its train-mode logits, whether two card
    steps from one state are bit-identical, and ``step_gaps`` of each
    step; and, as a control, the gaps that the CPU's second step with
    ``ema_gz`` set to 0 (the correction left out) shows against the CPU's
    right one. Both models are left in the CPU's state after the first
    step."""
    import torch

    start = {k: v.clone() for k, v in gpu.state_dict().items()}
    loss, logits, after = norm_step(gpu, batch["cuda"])
    gpu.load_state_dict(start)
    loss2, logits2, again = norm_step(gpu, batch["cuda"])
    same = bool(loss == loss2 and torch.equal(logits, logits2)
                and all(torch.equal(after[k], again[k]) for k in after))
    cl, clogits, cafter = norm_step(cpu, batch["cpu"])
    out = {"loss": {"cuda": loss, "cpu": cl,
                    "relative": abs(loss - cl) / abs(cl)},
           "logits": (logits, clogits), "two_steps_bit_identical": same,
           "step1": step_gaps(after, cafter, 1)}
    off = {k: (torch.zeros_like(v) if k.endswith("ema_gz") else v)
           for k, v in cafter.items()}
    cpu.load_state_dict(off)
    _, _, control = norm_step(cpu, batch["cpu"])
    gpu.load_state_dict(cafter)
    cpu.load_state_dict(cafter)
    _, _, after2 = norm_step(gpu, batch["cuda"])
    _, _, cafter2 = norm_step(cpu, batch["cpu"])
    out["step2"] = step_gaps(after2, cafter2, 2)
    out["control_no_correction"] = step_gaps(control, cafter2, 2)
    out["ema_gz_max_after_step1"] = max(
        float(v.abs().max()) for k, v in cafter.items()
        if k.endswith("ema_gz"))
    gpu.load_state_dict(cafter)
    cpu.load_state_dict(cafter)
    return out


def powernorm_module_check(valid, device: str = "cuda") -> dict:
    """``MinkPowerNorm(96, warmup_iters=2)`` on ``device`` against the
    CPU over 3 train steps and an eval forward, on seeded rows shaped as
    the batch (``valid``: its mask, padding rows holding junk): the
    largest gap of each output, gradient and statistic over the CPU
    leaf's largest entry; raises beyond ``NORM_STEP_TOL``."""
    import numpy as np
    import torch

    from nerf_downstream_tpu_torch.models.mink.powernorm import MinkPowerNorm
    from nerf_downstream_tpu_torch.sparse.types import SparseVoxels

    rng = np.random.default_rng(4)
    n, c = valid.shape[0], 96
    mods = {d: MinkPowerNorm(c, warmup_iters=2).to(d).train()
            for d in (device, "cpu")}
    w = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32))
    for m in mods.values():
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
    gaps: dict = {}

    def note(name, got, want):
        got, want = got.detach().cpu().float(), want.detach().float()
        g = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)
        gaps[name] = max(gaps.get(name, 0.0), g)

    for step in range(3):
        x = torch.from_numpy((rng.normal(size=(n, c)) * 2 + 0.3)
                             .astype(np.float32))
        gy = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
        x[~valid] = 1e3
        outs = {}
        for d, m in mods.items():
            xd = x.to(d).requires_grad_(True)
            m.weight.grad = m.bias.grad = None
            out = m(SparseVoxels(coords=torch.zeros((n, 4), dtype=torch.int32,
                                                    device=d),
                                 feats=xd, mask=valid.to(d))).feats
            (out * gy.to(d)).sum().backward()
            outs[d] = (out, xd.grad, m.weight.grad, m.bias.grad,
                       m.running_phi, m.ema_gz, m.iters)
        for name, got, want in zip(
                ("out", "d_x", "d_weight", "d_bias", "running_phi",
                 "ema_gz"), outs[device][:6], outs["cpu"][:6]):
            if name in ("out", "d_x"):
                got, want = got[valid.to(got.device)], want[valid]
            note(name, got, want)
        if not int(outs[device][6]) == int(outs["cpu"][6]) == step + 1:
            raise PhaseError("norms: PowerNorm iters differ")
    with torch.no_grad():
        x = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
        for d in (device, "cpu"):
            outs[d] = mods[d].eval()(SparseVoxels(
                coords=torch.zeros((n, 4), dtype=torch.int32, device=d),
                feats=x.to(d), mask=valid.to(d))).feats
        note("eval", outs[device][valid.to(outs[device].device)],
             outs["cpu"][valid])
    if not all(np.isfinite(v) and v <= NORM_STEP_TOL for v in gaps.values()):
        raise PhaseError(f"norms: PowerNorm module off the CPU: {gaps}")
    return {"rows": n, "channels": c, "gap_of_leaf_max": gaps}


def norm_step(model, batch):
    """One SGD step (lr 0.1, momentum 0.9 and weight decay 1e-4 as the
    flagship configs bind, no schedule) of the segmentation task on
    ``batch``: (loss, the train-mode logits, the state after the step)."""
    import torch

    from nerf_downstream_tpu_torch import serve
    from nerf_downstream_tpu_torch.train.modules import SegmentationTraining

    task = SegmentationTraining(model, scheduler_name="none", lr=0.1,
                                weight_decay=1e-4,
                                ignore_label=serve.IGNORE_LABEL)
    state = task.create_state()
    seen = []
    hook = model.register_forward_hook(
        lambda m, i, o: seen.append(o.detach().clone()))
    try:
        state, mets = task.train_step(state, batch)
    finally:
        hook.remove()
    return (float(mets["loss"]), seen[0],
            {k: v.detach().clone() for k, v in model.state_dict().items()})


def phase_norms(card: str, device: str = "cuda") -> dict:
    """Res16UNet18A at full width on one ``eval_64k`` batch with
    ``NORM_TYPE`` IN, LN and PN (seeded weights, every norm drawn away
    from identity, PowerNorm's ``ema_gz`` 0), f32 (TF32 off):

    - eval mode: the kernel path's logits within ``NORM_TOL`` x max|logit|
      of the CPU plain path's on the same weights; train mode the same
      (IN and LN compute the same in both modes, so their train-mode
      kernel logits are held to the CPU's; PN's come from the step);
    - ``MinkPowerNorm`` alone at the widest shape of the model (96
      channels, the batch's rows and padding), 3 train steps across a
      ``warmup_iters`` of 2: output, d_x, d_weight, d_bias,
      ``running_phi``, ``ema_gz`` and ``iters`` on the card within
      ``NORM_STEP_TOL`` x each leaf's largest of the CPU's;
    - two PN training steps (SGD, lr 0.1) of the whole model on the card
      against the CPU's, each from the same state (``pn_steps``): the
      first from ``ema_gz`` 0, the second from the state after the first,
      where the backward's EMA correction is at work. The first step's
      loss within 1e-5 relative and its train-mode logits as above;
      after each step ``iters`` equal, ``running_phi`` within
      ``NORM_STEP_TOL``; every weight holds the backward's gradients,
      which the card's kernels and the CPU's plain versions sum in
      different orders over 62,400 rows, so the weights are held to four
      times the worst gap of the same comparison on the BatchNorm model
      (no PowerNorm code in it), and ``ema_gz``, a mean of ``g' * z``
      over those rows whose terms cancel, to ``PN_EMA_TOL`` of each
      leaf's largest. A control, the CPU's second step with the
      correction left out, must lie beyond both limits;
    - two kernel-path PN steps from one state bit-identical (loss,
      logits, every weight and statistic).

    Reports each norm's eval forward device time beside BatchNorm's.
    ``device`` (the kernel path's) serves a rehearsal on the CPU."""
    import numpy as np
    import torch

    from nerf_downstream_tpu_torch import serve

    rng = np.random.default_rng(1)
    host = serve.make_batch("eval_64k", rng)
    batch = {"cuda": serve.to_device(host, device),
             "cpu": serve.to_device(host, "cpu")}
    valid = batch["cpu"]["mask"]
    line = {"phase": "norms", "card": card, "model": "Res16UNet18A",
            "preset": "eval_64k", "dtype": "float32",
            "rows": int(valid.sum()), "tolerance_of_max_logit": NORM_TOL,
            "step_tolerance_of_leaf_max": NORM_STEP_TOL, "norms": {}}

    def gap(got, ref):
        got, ref = got.cpu()[valid], ref.cpu()[valid]
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        return {"max_abs_err": err, "max_abs_logit": scale,
                "err_of_max": err / scale,
                "argmax_agreement": float((got.argmax(-1) == ref.argmax(-1))
                                          .float().mean())}

    def check(where, g):
        if not (np.isfinite(g["max_abs_err"])
                and g["max_abs_err"] <= NORM_TOL * g["max_abs_logit"]):
            raise PhaseError(f"norms {where}: {g}")

    line["powernorm_module"] = powernorm_module_check(valid, device)
    for norm_type in ("BN",) + NORM_TYPES:
        t0 = time.perf_counter()
        gpu, variables = norm_model(norm_type, device)
        entry = {"eval_device_ms": device_ms(
            lambda: serve.eval_step(gpu.eval(), batch["cuda"]), reps=3)}
        line["norms"][norm_type] = entry
        cpu, _ = norm_model(norm_type, "cpu", variables)
        if norm_type == "BN":  # the control of the whole-step comparison
            bn_worst = bn_step_worst(gpu, cpu, batch)
            entry["step_gap_of_leaf_max"] = {"max": bn_worst}
            entry["seconds"] = time.perf_counter() - t0
            del cpu, gpu
            continue
        ref = serve.eval_step(cpu.eval(), batch["cpu"])[0]
        entry["eval"] = gap(serve.eval_step(gpu.eval(), batch["cuda"])[0],
                            ref)
        check(f"{norm_type} eval", entry["eval"])
        if norm_type != "PN":
            gpu.train()
            with torch.inference_mode():
                got = gpu(batch_field(batch["cuda"]))
            entry["train"] = gap(got, ref)
            check(f"{norm_type} train", entry["train"])
        else:
            steps = pn_steps(gpu, cpu, batch)
            entry["train"] = gap(*steps.pop("logits"))
            check("PN train", entry["train"])
            w_bound = max(4 * bn_worst[1], NORM_STEP_TOL)
            entry.update(steps, weights_bound_4x_bn=w_bound,
                         ema_gz_bound=PN_EMA_TOL)
            held = all(steps[k]["running_phi"][1] <= NORM_STEP_TOL
                       and steps[k]["ema_gz"][1] <= PN_EMA_TOL
                       and steps[k]["weights"][1] <= w_bound
                       for k in ("step1", "step2"))
            control = steps["control_no_correction"]
            if not (steps["two_steps_bit_identical"] and held
                    and steps["loss"]["relative"] <= 1e-5
                    and control["ema_gz"][1] > PN_EMA_TOL
                    and control["weights"][1] > w_bound):
                raise PhaseError(f"norms PN steps: {entry}")
        entry["seconds"] = time.perf_counter() - t0
        del cpu, gpu
        torch.cuda.empty_cache()
    bn = line["norms"]["BN"]["eval_device_ms"]
    for nt in NORM_TYPES:
        line["norms"][nt]["eval_device_ms_over_bn"] = (
            line["norms"][nt]["eval_device_ms"] - bn)
    return line


def batch_field(batch):
    from nerf_downstream_tpu_torch.sparse.types import PointField

    return PointField(coords=batch["coordinates"], feats=batch["features"],
                      mask=batch["mask"])


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
    kept = {"cli_train": {}, "cli_cls": {}}  # trees phase cli_eval reads
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
        plan_recs = {"serving_8k": record_forward("serving_8k",
                                                  torch.bfloat16),
                     "eval_64k": rec}
        plan_recs["serving_8k"].k2 = []  # its plans are what phase k1 needs
        phase = "k2"
        line, k2 = phase_k2(rec)
        emit(line)
        rec.k2 = []
        del rec
        phase = "model"
        emit(phase_model())
        phase = "row_route"
        line, row_launches = phase_row_route(card)
        emit(line)
        phase = "models_extra"
        t0 = time.perf_counter()
        line, extra_launches = phase_models_extra(card)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        extra_k6 = k6_summary(line["ResUNetBN2C"]["row_gather_matmul"],
                              len(line["ResUNetBN2C"]["row_gather_matmul"]))
        extra_windowed = line["EncodedRes16UNet"]["kernels"]
        del line
        phase = "train"
        line, train_launches, train = phase_train(card, torch.bfloat16)
        emit(line)
        phase = "augment"
        emit(phase_augment())
        phase = "record_train"
        rec = record_train_step(train)
        del train
        plan_recs["train_64k"] = rec
        phase = "k1"
        line, k1, ws = phase_k1(plan_recs)
        emit(line)
        del plan_recs
        phase = "k3"
        line, k3 = phase_k3(rec)
        emit(line)
        phase = "k4"
        line, k4 = phase_k4(rec)
        emit(line)
        del rec
        phase = "train_model"
        emit(phase_train_model())
        phase = "cli_train"
        line, cli_launches = phase_cli_train(card, keep=kept["cli_train"])
        emit(line)
        phase = "cli_methods"
        t0 = time.perf_counter()
        line, methods_launches = phase_cli_methods(card, kept["cli_train"])
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        phase = "cli_kitti"
        t0 = time.perf_counter()
        line, kitti_launches = phase_cli_kitti(card)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        del line
        phase = "cli_cls"
        line, cls_launches = phase_cli_cls(card, keep=kept["cli_cls"])
        emit(line)
        cls_k6 = k6_summary(line["row_path_and_512"]["row_gather_matmul"],
                            line["k6_per_step"])
        phase = "ensemble"
        t0 = time.perf_counter()
        line, ens_launches, ens = phase_ensemble(card, kept["cli_cls"])
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        ens_kernels = line["kernels_per_step"]
        ens_k6 = k6_summary(line["row_gather_matmul"], line["k6_per_step"])
        phase = "optimizers"
        t0 = time.perf_counter()
        line, opt_launches = phase_optimizers(card, ens, kept["cli_cls"])
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        del ens
        phase = "cli_surface"
        t0 = time.perf_counter()
        line, surface_launches = phase_cli_surface(card, kept["cli_cls"])
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        phase = "cli_modelnet"
        t0 = time.perf_counter()
        line, mn_launches = phase_cli_modelnet(card)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        mn_k6 = k6_summary(line["row_gather_matmul"], line["k6_per_step"])
        del line
        phase = "cli_paconv"
        t0 = time.perf_counter()
        line, pac_launches = phase_cli_paconv(card)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        del line
        phase = "model_2d"
        t0 = time.perf_counter()
        line = phase_model_2d(card)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        for where in CLI_2D:
            phase = where
            emit(phase_cli_2d(card, where))
        phase = "sparse_eval"
        line, sparse_launches, sparse_recs = phase_sparse_eval(card)
        emit(line)
        phase = "k5"
        line, k5 = phase_k5(sparse_recs["k5"])
        emit(line)
        phase = "k6"
        line, k6 = phase_k6(sparse_recs["k6"])
        emit(line)
        del sparse_recs
        phase = "cli_eval"
        t0 = time.perf_counter()
        line, eval_launches = phase_cli_eval(card, kept)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        phase = "norms"
        t0 = time.perf_counter()
        line = phase_norms(card)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        phase = "cli_semseg"
        t0 = time.perf_counter()
        line, semseg_launches = phase_cli_semseg(card)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        semseg_k4 = line["k4_per_step"]
        semseg_k3dw = line["k3_dw_per_step"]
        del line
    except Exception as e:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        import shutil

        for k in kept.values():
            shutil.rmtree(k.get("tmp", ""), ignore_errors=True)
        raise

    def paths(name):
        by_path = {"serve": launches[name], "train": train_launches[name],
                   "cli_train": cli_launches[name],
                   "cli_cls": cls_launches[name],
                   "ensemble": ens_launches[name],
                   "optimizers": opt_launches[name],
                   "cli_surface": surface_launches[name],
                   "cli_modelnet": mn_launches[name],
                   "cli_paconv": pac_launches[name],
                   "row_route": row_launches[name],
                   "models_extra": extra_launches[name],
                   "cli_eval": eval_launches[name],
                   "cli_semseg": semseg_launches[name],
                   "cli_methods": methods_launches[name],
                   "cli_kitti": kitti_launches[name],
                   "sparse_eval": sparse_launches[name]}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    src = "nerf_downstream_tpu_torch/ops/kernels/"
    tpu = "nerf_downstream_tpu/ops/pallas/window_gather.py"
    # why library_ms is null: no single PyTorch call computes these
    no_library = {
        "window_starts": "a searchsorted of the tile-boundary keys, then a "
                         "min and max over the members, a running max, a "
                         "floor and a count: several calls",
        "window_match": "searchsorted ranks in the whole table, not the "
                        "in-window rank or -1",
        "window_gather_matmul": "a per-offset gather and product summed "
                                "over the offsets of a plan",
        "window_bwd": "a gather-matmul over the inverse plan plus a "
                      "per-offset gathered outer-product sum",
        "window_dw": "a per-offset gathered outer-product sum",
        "window_gather_matmul_bs": "a per-offset gather and product over "
                                   "the live weight blocks, summed over the "
                                   "offsets of a plan",
        "row_gather_matmul": "a per-offset gather of the rows a kernel map "
                             "names and product, summed over the offsets "
                             "(index_select and bmm are two calls that "
                             "materialise the [K, N, Cin] gathers)",
    }
    kernels = [
        dict(name="window_starts", route="cuda",
             source=src + "window_match.cu",
             replaces="nerf_downstream_tpu/ops/window_conv.py:241 (the "
                      "window starts around window_match_pallas, XLA ops "
                      "under jit)",
             bound_by="bytes", library_ms=None,
             shapes="one eval_64k forward (bf16)", **paths("window_starts"),
             **ws, models_extra_f32_per_step=extra_windowed["window_starts"],
             ensemble_f32_per_step=ens_kernels["window_starts"]),
        dict(name="window_match", route="cuda",
             source=src + "window_match.cu", replaces=f"{tpu}:387",
             bound_by="bytes", library_ms=None,
             shapes="one eval_64k forward (bf16)",
             **paths("window_match"), **k1,
             models_extra_f32_per_step=extra_windowed["window_match"],
             ensemble_f32_per_step=ens_kernels["window_match"]),
        dict(name="window_gather_matmul", route="cuda",
             source=src + "window_gather_matmul.cu", replaces=f"{tpu}:131",
             library_ms=None, shapes="one eval_64k forward (bf16)",
             **paths("window_gather_matmul"), **k2,
             models_extra_f32_per_step=extra_windowed[
                 "window_gather_matmul"],
             ensemble_f32_per_step=ens_kernels["window_gather_matmul"]),
        dict(name="window_bwd", route="cuda", source=src + "window_bwd.cu",
             replaces=f"{tpu}:504", library_ms=None,
             shapes="one train_64k step (bf16)", **paths("window_bwd"),
             **k3, cli_semseg_dw_half_f32_per_step=semseg_k3dw,
             models_extra_f32_per_step=extra_windowed["window_bwd"],
             ensemble_f32_per_step=ens_kernels["window_bwd"]),
        dict(name="window_dw", route="cuda", source=src + "window_dw.cu",
             replaces=f"{tpu}:590", library_ms=None,
             shapes="one train_64k step (bf16)", **paths("window_dw"), **k4,
             cli_semseg_f32_per_step=semseg_k4,
             models_extra_f32_per_step=extra_windowed["window_dw"]),
        dict(name="window_gather_matmul_bs", route="cuda",
             source=src + "window_gather_matmul_bs.cu",
             replaces=f"{tpu}:284", library_ms=None,
             shapes="one eval_64k forward, csr at granularity 32 (bf16)",
             **paths("window_gather_matmul_bs"), **k5),
        dict(name="row_gather_matmul", route="cuda",
             source=src + "row_gather_matmul.cu",
             replaces="nerf_downstream_tpu/ops/pallas/gather_matmul.py:76",
             library_ms=None, shapes="one eval_64k forward, ZAXIS (bf16 "
             "inputs, f32 output)", **paths("row_gather_matmul"), **k6,
             cli_cls_f32_per_step=cls_k6, cli_modelnet_f32_per_step=mn_k6,
             models_extra_f32_per_step=extra_k6,
             ensemble_f32_per_step=ens_k6),
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
