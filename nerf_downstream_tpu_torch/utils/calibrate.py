"""Auto-calibration of the windowed-conv capacity knobs from scanned
batches (counterpart of ``nerf_downstream_tpu/utils/calibrate.py``).

Per-level row caps, window coverage and escape budgets are statistics of
the data (occupied rows of a surface shell thin about 4x per stride
doubling; the input span of a tile depends on the scenes and on which
scenes sit side by side in the batch). ``calibrate`` measures them with
the plan construction the convs use (``ops/window_conv.py::build_plan_direct``:
on the card K1, the window-starts pass and the escape search) over each
batch and its scene-order permutations: the Williams-design orders that
make every ordered scene pair adjacent once (``_adjacency_orders``; in
rank space a window span changes only at scene boundaries) and
``permutations`` random orders from ``default_rng(seed)``. It derives

- ``level_caps[i]``: the most unique rows at stride 2^i x ``slack``,
  rounded up to a tile multiple;
- ``window_blocks``: the smallest same-set coverage whose escapes stay
  under ``max_escape_frac`` of the level's rows at every level;
- ``window_cross_blocks`` and ``window_expand_factor``: the smallest
  cross-set coverages with no escape (cross-set plans have no escape
  list);
- ``window_escape_cap[i]`` / ``window_escape_tiles[i]``: the measured
  most escaped entries / candidate tiles x ``slack``, rounded up (a power
  of two for caps).

With the reference's orders, shuffles, slack and rounding the knobs are
integer-equal to the reference's on the same batches. Where the
configuration moves coordinate transforms onto the device
(``train.device_transforms``), each batch is measured under several
realisations of them, drawn from a ``torch.Generator`` seeded with
``seed + 1000 r`` as the port's device transforms draw; the reference
applies their host twins from its numpy stream, so the knobs then match
the reference's in distribution, not draw for draw.

``maybe_auto_calibrate`` measures the first train batches of a
DataModule, as the reference's does, and then more of them: a knob set
from two augmented batches bounds later batches only by chance (the
reference's own CLI test NaN-poisons a train step and its validation
that way), so the port also measures the validation batches the knobs
do not cover, and draws train batches until ``FRESH_BATCHES`` in a row
run under the knobs, measuring each one that does not (ROADMAP.md Queue
3). It draws them from copies of the run's streams, so the run's own
batches do not depend on how many were measured.
"""

from __future__ import annotations

import contextlib
import copy
import logging
from typing import Iterable

import numpy as np
import torch

from nerf_downstream_tpu_torch import config as cfg

STRIDES = (1, 2, 4, 8, 16)
BLOCK_CHOICES = (2, 3, 4, 6, 8)
# maybe_auto_calibrate: train batches in a row that must run under the
# knobs, and the most train batches it draws after the first ones
FRESH_BATCHES = 8
MAX_DRAWS = 64


def _level_rows(batch: dict, stride: int) -> np.ndarray:
    """Valid unique (b, x, y, z) rows of the stride level (floor-coarsened
    in finest-voxel units, as the model's levels are)."""
    coords = np.asarray(batch["coordinates"])
    mask = np.asarray(batch["mask"]).astype(bool)
    c = coords[mask]
    v = np.floor(c[:, 1:4]).astype(np.int64)
    b = c[:, :1].astype(np.int64)
    v = (v // stride) * stride
    return np.unique(np.concatenate([b, v], 1), axis=0)


def _sorted_level_coords(rows: np.ndarray, tile: int, cap: int, device):
    """The level's rows padded to ``cap`` and key-sorted (``build_plan_direct``
    needs key order), as tensors on ``device``."""
    from nerf_downstream_tpu_torch.sparse import packing

    n_valid = rows.shape[0]
    assert cap >= n_valid and cap % tile == 0
    coords = np.zeros((cap, 4), np.float32)
    coords[:n_valid] = rows
    c = torch.as_tensor(coords, device=device)
    m = torch.arange(cap, device=device) < n_valid
    hi, lo = packing.pack(c, m)
    _, _, order = packing.sort_with_payload(
        hi, lo, torch.arange(cap, dtype=torch.int32, device=device))
    order = order.long()
    return c[order], m[order]


def _plan_escape_stats(coords, mask, tile: int, window: int, blocks: int,
                       stride: int = 1):
    """(escaped entries, candidate tiles, far overflow?) of the same-set
    k3 plan at this coverage: the accounting the runtime's escape guard
    budgets (n_gt candidate tiles, n_dt demoted-entry tiles, n_esc entries),
    with every candidate tile searched. ``stride`` is the level's tensor
    stride: the runtime's offsets there are +-stride.

    The reference searches all 9 nT tiles; only the n_gt flagged and n_dt
    demoting tiles can hold an escape (an unflagged tile's matches all lie
    inside its window), and the two counts do not depend on how many
    tiles are searched. So a first build searching one tile gives them,
    and a second searching max(n_gt, n_dt) tiles gives the same entries
    and overflow as the full search, in a fraction of the time."""
    from nerf_downstream_tpu_torch.ops import window_conv as W
    from nerf_downstream_tpu_torch.sparse.kernels import kernel_offsets

    offs = kernel_offsets(3, stride)

    def plan(tiles):
        return W.build_plan_direct(
            coords, mask, offs, tile=tile, window=window, blocks=blocks,
            escape_cap=1 << 30, escape_tiles=tiles)

    n_gt, n_dt, _ = (int(v) for v in plan(1).esc_stats.tolist())
    p = plan(max(1, n_gt, n_dt))
    n_esc = int(p.esc_stats[2])
    # with every candidate searched, n_escaped > 0 means a span beyond
    # the escape slice
    far = int(p.n_escaped) > 0
    return n_esc, max(n_gt, n_dt), far


def _cross_escapes(per: dict, s: int, tile: int, window: int, blocks: int,
                   expanding: bool) -> int:
    """Escapes of the stride s -> 2s cross-set plan in the runtime's
    ``window_plan_cross`` geometry: expanding = the coarse query over the
    fine table at half the tile; contracting = the fine query over the
    coarse table, transposed."""
    from nerf_downstream_tpu_torch.ops import window_conv as W
    from nerf_downstream_tpu_torch.sparse.kernels import kernel_offsets

    fine_c, fine_m = per[s]
    coarse_c, coarse_m = per[2 * s]
    offs = kernel_offsets(2, s)
    if expanding:
        plan = W.build_plan_direct(
            fine_c, fine_m, offs, tile=max(32, tile // 2), window=window,
            blocks=blocks, out_coords=coarse_c, out_mask=coarse_m,
        )
    else:
        plan = W.build_plan_direct(
            coarse_c, coarse_m, offs, tile=tile, window=window,
            blocks=blocks, transpose=True, out_coords=fine_c,
            out_mask=fine_m,
        )
    return int(plan.n_escaped)


def _adjacency_orders(n: int) -> list:
    """Scene orders that make every ordered scene pair adjacent at least
    once (Williams row-complete designs): the n cyclic shifts of u = [0, 1,
    n-1, 2, n-2, ...], and for odd n those of its reverse too; the
    identity (always measured) is left out."""
    if n <= 1:
        return []
    u = [0]
    for k in range(1, n):
        u.append((k + 1) // 2 if k % 2 else n - k // 2)
    rows = [u]
    if n % 2:
        rows.append(list(reversed(u)))
    out = []
    for base in rows:
        for shift in range(n):
            out.append(np.asarray([(v + shift) % n for v in base]))
    return [o for o in out if not np.array_equal(o, np.arange(n))]


def _relabeled(rows: np.ndarray, order: np.ndarray) -> np.ndarray:
    """A level's rows with the scenes in ``order``: the reference
    relabels the batch's coordinates before taking the level
    (``_permuted``); relabelling is a bijection on scene ids, so the
    level's rows relabel alike and need no second ``unique``."""
    out = rows.copy()
    remap = np.argsort(order)
    out[:, 0] = remap[np.clip(rows[:, 0], 0, len(order) - 1)]
    return out


def _coord_device_transforms() -> tuple:
    """The configured device transforms that move coordinates."""
    from nerf_downstream_tpu_torch.data import device_transforms as DT
    from nerf_downstream_tpu_torch.data import transforms as T

    return tuple(n for n in DT.configured_names() if n in T.COORD_AFFECTING)


def _apply_device_coord_transforms(batch: dict, seed: int, device) -> dict:
    """The batch with its coordinates as the model sees them: the
    configured coordinate device transforms applied on ``device`` with a
    generator seeded by ``seed``."""
    from nerf_downstream_tpu_torch.data import device_transforms as DT

    names = _coord_device_transforms()
    if not names:
        return batch
    coords = torch.as_tensor(np.asarray(batch["coordinates"]),
                             dtype=torch.float32, device=device)
    mask = torch.as_tensor(np.asarray(batch["mask"]).astype(bool),
                           device=device)
    n_scenes = int(np.asarray(batch["coordinates"])[:, 0].max()) + 1
    fn = DT.build(names, n_scenes, DT.configured_params(names))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = fn({"coordinates": coords, "mask": mask}, gen)
    return dict(batch, coordinates=out["coordinates"].cpu().numpy())


def calibrate(
    batches: Iterable[dict],
    tile: int = 256,
    window: int = 128,
    permutations: int = 4,
    slack: float = 1.2,
    max_escape_frac: float = 0.05,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Measure collated batches (``coordinates`` and ``mask`` at least)
    -> the CoordinateContext knob dict. Each batch is measured as it is,
    in the adjacency orders and in ``permutations`` random scene orders.
    The plans are built on ``device``."""
    from nerf_downstream_tpu_torch.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    batches = list(batches)
    assert batches, "calibration needs at least one batch"
    # a stochastic device warp draws anew every step: measure several
    # realisations per batch (and leave a margin below)
    warped = bool(_coord_device_transforms())
    warp_samples = 4 if warped else 1
    batches = [
        _apply_device_coord_transforms(b, seed + 1000 * r, device)
        for b in batches
        for r in range(warp_samples)
    ]
    n_scenes = int(
        max(np.asarray(b["coordinates"])[:, 0].max() for b in batches)
    ) + 1

    # (batch, scene order or None) of every measured variant
    variants = []
    adj = _adjacency_orders(n_scenes)
    for bi in range(len(batches)):
        variants.append((bi, None))
        # the adjacency orders on each source batch's first realisation;
        # random orders on every realisation
        if bi % warp_samples == 0:
            for order in adj:
                variants.append((bi, order))
        for _ in range(permutations):
            variants.append((bi, rng.permutation(n_scenes)))

    base_rows = [{s: _level_rows(b, s) for s in STRIDES} for b in batches]
    all_rows = {s: [base_rows[bi][s] if order is None
                    else _relabeled(base_rows[bi][s], order)
                    for bi, order in variants] for s in STRIDES}
    max_rows = {s: max(r.shape[0] for r in all_rows[s]) for s in STRIDES}
    level_caps = tuple(
        max(tile, int(np.ceil(max_rows[s] * slack / tile)) * tile)
        for s in STRIDES
    )
    # the stride-1 plan runs at the batch's own capacity (level_caps[0]
    # never applies there); escape and tile budgets shift with the padded
    # tile count, so measure at the largest input capacity
    in_cap = int(
        max(np.asarray(b["coordinates"]).shape[0] for b in batches)
    )
    meas_caps = (max(in_cap, level_caps[0]),) + level_caps[1:]
    level_sets = []
    for vi in range(len(variants)):
        level_sets.append({
            s: _sorted_level_coords(all_rows[s][vi], tile, meas_caps[i],
                                    device)
            for i, s in enumerate(STRIDES)
        })

    # the smallest same-set coverage whose escapes stay under
    # max_escape_frac at every level (same-set plans have the escape list,
    # so this coverage is a speed frontier, not a correctness bound)
    chosen = None
    stats = None
    for blocks in BLOCK_CHOICES:
        ok = True
        per_level_entries = {s: 0 for s in STRIDES}
        per_level_tiles = {s: 0 for s in STRIDES}
        for per in level_sets:
            for s in STRIDES:
                coords, mask = per[s]
                entries, tiles, far = _plan_escape_stats(
                    coords, mask, tile, window, blocks, stride=s
                )
                if far or entries > max_escape_frac * max_rows[s] * 3:
                    ok = False
                    break
                per_level_entries[s] = max(per_level_entries[s], entries)
                per_level_tiles[s] = max(per_level_tiles[s], tiles)
            if not ok:
                break
        if ok:
            chosen, stats = blocks, (per_level_entries, per_level_tiles)
            break
    assert chosen is not None, (
        f"no coverage in {BLOCK_CHOICES} fits this workload at window "
        f"{window} / tile {tile} — raise window or inspect the data"
    )
    entries, tiles = stats

    # cross-set plans have no escape list: their coverage is a hard
    # bound. Contracting (transpose convs) first:
    cross = None
    for blocks in BLOCK_CHOICES:
        if blocks < chosen:
            continue
        if all(
            _cross_escapes(per, s, tile, window, blocks, expanding=False)
            == 0
            for per in level_sets
            for s in STRIDES[:-1]
        ):
            cross = blocks
            break
    assert cross is not None, (
        f"no cross-set coverage in {BLOCK_CHOICES} covers the transpose "
        f"spans at window {window} — raise window"
    )

    # expanding (s2 down convs): the smallest factor with no escape
    expand = None
    for cand in (2, 3, 4, 6):
        if all(
            _cross_escapes(per, s, tile, window, cross * cand,
                           expanding=True) == 0
            for per in level_sets
            for s in STRIDES[:-1]
        ):
            expand = cand
            break
    assert expand is not None, (
        "no window_expand_factor in (2, 3, 4, 6) covers the down-conv "
        f"spans at window {window} — raise window"
    )

    def pow2_cap(x: int) -> int:
        # slack and a floor: small measured counts vary by more than a
        # factor on unseen batches
        return 1 << int(np.ceil(np.log2(max(int(x * slack) + 32, 1))))

    # a level binds escape cap 0 only when no variant had a candidate or
    # demoted tile (at cap 0 the runtime poisons on the conservative tile
    # indicator); under a stochastic warp every escaping level gets one
    # more doubling, and clean levels below an escaping one a floor cap
    warp_mult = 2 if warped else 1
    escape_cap = list(
        pow2_cap(entries[s]) * warp_mult
        if (entries[s] or tiles[s]) else 0
        for s in STRIDES
    )
    escape_tiles = list(
        max(4, int(np.ceil(tiles[s] * slack * warp_mult)) + 2)
        if escape_cap[i] else 4
        for i, s in enumerate(STRIDES)
    )
    if warped and any(escape_cap):
        deepest = max(i for i, c in enumerate(escape_cap) if c)
        for i in range(deepest + 1, len(escape_cap)):
            # a level inside one coverage cannot escape: keep 0 there
            if max_rows[STRIDES[i]] > chosen * window:
                escape_cap[i] = 256
                escape_tiles[i] = max(escape_tiles[i], 4)
    knobs = {
        "level_caps": level_caps,
        "window_tile": tile,
        "window_size": window,
        "window_blocks": chosen,
        "window_cross_blocks": cross,
        "window_expand_factor": expand,
        "window_escape_cap": tuple(escape_cap),
        "window_escape_tiles": tuple(escape_tiles),
    }
    logging.info(f"calibrated CoordinateContext knobs: {knobs}")
    return knobs


def gin_text(knobs: dict) -> str:
    lines = ["# auto-generated by nerf_downstream_tpu_torch.utils.calibrate"]
    for k, v in knobs.items():
        lines.append(f"CoordinateContext.{k} = {v!r}")
    return "\n".join(lines) + "\n"


def bind(knobs: dict):
    for k, v in knobs.items():
        cfg.bind("CoordinateContext", k, v)


def needs_calibration() -> bool:
    """Whether the configuration is windowed and binds neither
    ``level_caps`` nor ``window_escape_cap`` (a configuration that binds
    one is a measured one)."""
    q = cfg.query_parameter
    method = q("CoordinateContext.method", default="auto")
    extent = q("CoordinateContext.grid_extent", default=None)
    windowed = method == "hybrid" or (method == "auto" and extent)
    return bool(windowed
                and q("CoordinateContext.level_caps", default=None) is None
                and q("CoordinateContext.window_escape_cap",
                      default=None) is None)


def covers(knobs: dict, batch: dict, device="cuda") -> bool:
    """Whether ``batch`` runs under ``knobs`` without tripping a guard, in
    ``calibrate``'s model of the convs: no level beyond its cap, every
    same-set k3 plan placing its entries within its escape budget, every
    cross-set plan without an escape."""
    from nerf_downstream_tpu_torch.device import resolve_device
    from nerf_downstream_tpu_torch.ops import window_conv as W
    from nerf_downstream_tpu_torch.sparse.kernels import kernel_offsets

    device = resolve_device(device)
    tile, window = knobs["window_tile"], knobs["window_size"]
    cap = int(np.asarray(batch["coordinates"]).shape[0])
    per = {}
    for i, s in enumerate(STRIDES):
        rows = _level_rows(batch, s)
        if s > 1 and knobs["level_caps"][i] < cap:  # else uncapped
            cap = int(knobs["level_caps"][i])
        if rows.shape[0] > cap:
            return False
        per[s] = _sorted_level_coords(rows, tile, cap, device)
        plan = W.build_plan_direct(
            *per[s], kernel_offsets(3, s), tile=tile, window=window,
            blocks=knobs["window_blocks"],
            escape_cap=int(knobs["window_escape_cap"][i]),
            escape_tiles=int(knobs["window_escape_tiles"][i]) or 64)
        if int(plan.n_escaped):
            return False
    cross = knobs["window_cross_blocks"]
    return not any(
        _cross_escapes(per, s, tile, window,
                       cross * (knobs["window_expand_factor"] if e else 1), e)
        for s in STRIDES[:-1] for e in (False, True))


def coverage_report(knobs: dict, batch: dict, device="cuda") -> dict:
    """``covers`` with what decides it: the batch's valid rows per level
    and the stride-1 same-set plan's (escaped entries, candidate tiles,
    far overflow?) at the knobs' coverage, every candidate searched."""
    from nerf_downstream_tpu_torch.device import resolve_device

    device = resolve_device(device)
    tile = knobs["window_tile"]
    finest = _sorted_level_coords(
        _level_rows(batch, 1), tile,
        int(np.asarray(batch["coordinates"]).shape[0]), device)
    return {"covered": covers(knobs, batch, device),
            "level_rows": [int(_level_rows(batch, s).shape[0])
                           for s in STRIDES],
            "stride1_entries_tiles_far": list(_plan_escape_stats(
                *finest, tile, knobs["window_size"],
                knobs["window_blocks"]))}


@contextlib.contextmanager
def _own_streams(data_module):
    """A copy of ``data_module`` whose batch order, subsampling and host
    transforms draw from copies of the run's streams, with one loader
    thread (no prefetched batches left to drain): what it yields first is
    what the run yields first, and the run's streams stay where they
    were."""
    from nerf_downstream_tpu_torch.data import transforms

    dm = copy.copy(data_module)
    dm.rng = copy.deepcopy(data_module.rng)
    dm.train_num_workers = dm.val_num_workers = 1
    saved = transforms._rng
    transforms._rng = copy.deepcopy(saved)
    try:
        yield dm
    finally:
        transforms._rng = saved


def maybe_auto_calibrate(data_module, num_batches: int = 2,
                         dry_run: bool = False, device="cuda", **kw) -> bool:
    """Measure and bind the knobs when ``needs_calibration()``, from the
    batches of ``data_module`` (its transforms, collation and capacities;
    drawn from copies of its streams, ``_own_streams``): the first
    ``num_batches`` train and validation batches, as the reference
    measures train batches; then every validation batch the knobs do not
    cover (``covers``), and train batches drawn until ``FRESH_BATCHES`` in
    a row run under the knobs, each one that does not joining the
    measured set (at most ``MAX_DRAWS`` draws; a warning if they run out
    first). A later batch may still exceed them: the guards then poison
    it. Returns whether knobs were bound; ``dry_run`` only says whether
    they would be."""
    if not needs_calibration():
        return False
    if dry_run:
        return True
    tile = cfg.query_parameter("CoordinateContext.window_tile", default=256)
    win = cfg.query_parameter("CoordinateContext.window_size", default=128)
    kw.setdefault("tile", int(tile))
    kw.setdefault("window", int(win))
    def coords(batch):  # all that is measured
        return {"coordinates": batch["coordinates"], "mask": batch["mask"]}

    with _own_streams(data_module) as dm:
        it = map(coords, dm.train_batches())
        val = [coords(b) for b in dm.val_batches()]
        batches = [next(it) for _ in range(num_batches)] + val[:num_batches]
        knobs = calibrate(batches, device=device, **kw)
        val_checked, clean, draws = False, 0, 0
        while clean < FRESH_BATCHES and draws < MAX_DRAWS:
            if not val_checked:  # again after every new calibration
                missed = [b for b in val if not covers(knobs, b, device)]
                val_checked = not missed
                if missed:
                    batches += missed
                    knobs = calibrate(batches, device=device, **kw)
                continue
            b = next(it)
            draws += 1
            if covers(knobs, b, device):
                clean += 1
            else:
                batches.append(b)
                knobs = calibrate(batches, device=device, **kw)
                clean, val_checked = 0, False
    if clean < FRESH_BATCHES:
        logging.warning(
            f"calibration drew {draws} train batches without "
            f"{FRESH_BATCHES} in a row under the knobs (the last "
            f"{clean}); later batches may trip a guard: pin wider knobs "
            "with co3d_3d.calibrate")
    logging.info(f"calibrated from {len(batches)} batches; {clean} fresh "
                 f"train batches in a row ran under the knobs")
    bind(knobs)
    return True
