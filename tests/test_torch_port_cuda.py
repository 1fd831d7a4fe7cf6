"""The port's CUDA kernels on the card against the same code on the CPU,
at small shapes with the edges the full-width smoke run does not reach:
row counts that are not a multiple of the kernel's 64-row block, channel
counts that are not a multiple of its 16-channel chunk or 64-column
block, members with no entry at all, masked queries, windows that run
past the key table, escape lists in use, and d_w reductions over one and
over several row chunks.

Every test needs a GPU and ``nvcc`` and skips without them. On a machine
with the card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Plans built on the card (K1) must equal those built on the CPU (the plain
version) exactly; K2, and K3's d_feats, must match the plain version within
atol = rtol = 1e-5 in f32, and within rtol = 2^-8 in bf16 against the f32
sum (one rounding into bf16 is at most 2^-9 relative). d_w (K3 and K4) is
an f32 sum whose plain version takes the same inputs, so it must match
within 1e-5 of its largest value in both types, and be bit-identical
between two launches. A small training step on the card must match the same step on
the CPU: the loss within 1e-5 relative, each gradient within 1e-4 of its
largest value. K5 must match its plain version as K2 does, and equal K2
on the spec-masked weights bit for bit in both types (in bf16 both run
the tensor cores with the same column tile and term split); K6 (f32
output for both input types) within atol = rtol = 1e-5; a small model in
the pruned-eval modes on the card must match the CPU within 1e-4. The
bf16 tensor-core path of K2, K3, K4 and K5 is held to the same tolerances
at ragged shapes, with and without its split of the terms over blocks
(K4 and K3's d_w over one and over many row chunks), and must be
bit-identical from launch to launch and carry a NaN input row to exactly
the outputs that name it (K5: that a live block multiplies it into).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nerf_downstream_tpu_torch.ops import kernels as K  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as wc  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as sk  # noqa: E402
from nerf_downstream_tpu_torch.sparse import packing  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import PointField  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def level(seed, n=640, valid=560, extent=12, batches=2):
    """(coords, mask) of a sorted level (and its stride-2 parent), on the
    CPU."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((n, 4), np.float32)
    coords[:, 1:] = rng.integers(-extent // 2, extent // 2, (n, 3))
    coords[:, 0] = rng.integers(0, batches, n)
    field = PointField(coords=torch.as_tensor(coords),
                       feats=torch.zeros(n, 1),
                       mask=torch.as_tensor(np.arange(n) < valid))
    sv, _ = sk.field_to_sparse(field)
    coarse, _ = sk.stride_coords_capped(sv, 2, None)
    return (sv.coords, sv.mask), (coarse.coords, coarse.mask)


def unique_level(seed, n, extent=12, batches=2):
    """(coords, mask) of a sorted level whose n rows are all valid and
    distinct: no padding rows, so a query above every key overshoots the
    fixed-step lower bound to n + 1."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(batches * extent ** 3, n, replace=False)
    b, rest = np.divmod(cells, extent ** 3)
    x, rest = np.divmod(rest, extent ** 2)
    y, z = np.divmod(rest, extent)
    coords = np.stack([b, x, y, z], 1).astype(np.float32)
    coords[:, 1:] -= extent // 2
    field = PointField(coords=torch.as_tensor(coords),
                       feats=torch.zeros(n, 1),
                       mask=torch.ones(n, dtype=torch.bool))
    sv, _ = sk.field_to_sparse(field)
    return sv.coords, sv.mask


# the window-starts pass's cases: the hierarchical lower bound (a table of
# a multiple of 256 rows), the fixed-step one with its n + 1 overshoot
# (1,000 and 200 rows, all valid), masked tail tiles, a cross plan at tile
# 128 and blocks 6, and a transposed (negated) offset set
STARTS_CASES = {
    "hier_512": dict(n=512, valid=450, tile=32, window=16, blocks=2),
    "fixed_1000": dict(n=1000, unique=True, tile=32, window=16, blocks=2),
    "fixed_200": dict(n=200, unique=True, tile=32, window=16, blocks=2),
    "masked_tail": dict(n=512, valid=200, tile=32, window=16, blocks=2),
    "cross_tile128": dict(n=1024, valid=900, tile=128, window=32, blocks=6,
                          cross="expanding"),
    "transposed": dict(n=512, valid=450, tile=64, window=32, blocks=4,
                       cross="contracting"),
}


def starts_case(name, seed=0):
    """(table, query or None, offsets, build_plan_direct keywords) of a
    window-starts case, on the CPU."""
    kw = dict(STARTS_CASES[name])
    n = kw.pop("n")
    valid = kw.pop("valid", n)
    cross = kw.pop("cross", None)
    if kw.pop("unique", False):
        fine, coarse = unique_level(seed, n), None
    else:
        fine, coarse = level(seed, n=n, valid=valid)
    if cross is None:
        return fine, None, sk.kernel_offsets(3, 1), kw
    if cross == "expanding":
        return fine, coarse, sk.kernel_offsets(2, 1), kw
    return coarse, fine, sk.kernel_offsets(2, 1), dict(kw, transpose=True)


def starts_args(table, query, offs, tile, window, blocks, transpose=False,
                device="cpu"):
    """``window_starts``'s arguments for the plan ``build_plan_direct``
    would build from these inputs."""
    coords, mask = (t.to(device) for t in table)
    q_coords, q_mask = ((coords, mask) if query is None
                        else (t.to(device) for t in query))
    hi, lo = packing.pack(coords, mask)
    o_hi, o_lo = packing.pack(q_coords, q_mask)
    _, deltas = wc.plan_layout(offs, transpose)
    return (hi, lo, o_hi, o_lo, mask.sum(dtype=torch.int32),
            q_mask.sum(dtype=torch.int32), deltas,
            wc.window_tile(q_coords.shape[0], tile), window, blocks)


def plans_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if torch.is_tensor(x):
            assert torch.equal(x.cpu(), y.cpu()), f.name
        else:
            assert x == y, f.name


PLAN_CASES = {
    "same_set_escapes": dict(tile=32, window=16, blocks=2, escape_cap=4096,
                             escape_tiles=200),
    "same_set_strict": dict(tile=64, window=32, blocks=2),
    "expanding": dict(tile=32, window=32, blocks=12, cross="expanding"),
    "contracting": dict(tile=64, window=32, blocks=4, cross="contracting"),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plans_on_card_equal_cpu(cuda, case):
    """Whole plans (K1 plus the escape search) built on the card equal the
    plans the CPU builds with K1's plain version."""
    kw = dict(PLAN_CASES[case])
    cross = kw.pop("cross", None)
    fine, coarse = level(1)
    if cross is None:
        table, query, offs = fine, None, sk.kernel_offsets(3, 1)
    elif cross == "expanding":
        table, query, offs = fine, coarse, sk.kernel_offsets(2, 1)
    else:
        table, query, offs = coarse, fine, sk.kernel_offsets(2, 1)
        kw["transpose"] = True
    plans = []
    for dev in ("cpu", cuda):
        extra = {} if query is None else dict(out_coords=query[0].to(dev),
                                              out_mask=query[1].to(dev))
        plans.append(wc.build_plan_direct(table[0].to(dev), table[1].to(dev),
                                          offs, **kw, **extra))
    plans_equal(plans[1], plans[0])
    if case == "same_set_escapes":
        assert int(plans[0].esc_stats[2]) > 0


def test_k1_launch_matches_plain(cuda):
    """K1 launched directly, with starts pushed to the end of the table so
    the windows read past it, against the plain version on the card."""
    (c, m), _ = level(2)
    hi, lo = (t.to(cuda) for t in packing.pack(c, m))
    n = hi.shape[0]
    rng = np.random.default_rng(3)
    g, mm, tile, window, blocks = 9, 3, 32, 32, 6
    starts = torch.as_tensor(
        np.sort(rng.integers(0, n, (g, n // tile)), 1) // window * window,
        dtype=torch.int32).contiguous().to(cuda)
    deltas = rng.integers(-2 ** 31, 2 ** 31, (g, mm, 2))
    deltas[:, :, 0] = rng.integers(-1, 2, (g, mm))
    deltas[:, 0] = 0  # the identity offset: every valid query matches
    deltas = tuple(tuple((int(h), int(lw)) for h, lw in row) for row in deltas)
    mask = m.to(cuda).clone()
    mask[::7] = False
    args = (hi, lo, hi, lo, mask, deltas, starts, tile, window, blocks)
    got = K.window_match(*args)
    want = K.window_match_plain(*args)
    assert torch.equal(got, want)
    assert (got[:, :, 0] >= 0).any()


@pytest.mark.parametrize("case", sorted(STARTS_CASES) + ["rows_65536"])
def test_window_starts_matches_plain(cuda, case):
    """The window-starts pass on the card equals its plain version on the
    card bit for bit (starts, emax, n_escaped), and repeats exactly."""
    if case == "rows_65536":
        table, _ = level(9, n=65536, valid=62400, extent=48, batches=8)
        query, offs = None, sk.kernel_offsets(3, 1)
        kw = dict(tile=256, window=512, blocks=2)
    else:
        table, query, offs, kw = starts_case(case)
    args = starts_args(table, query, offs, device=cuda, **kw)
    got = K.window_starts(*args)
    want = K.window_starts_plain(*args)
    for name, a, b in zip(("starts", "emax", "n_escaped"), got, want):
        assert a.dtype == b.dtype == torch.int32, name
        assert torch.equal(a, b), name
    assert all(torch.equal(a, b) for a, b in zip(K.window_starts(*args),
                                                  got))
    if case.startswith("fixed"):  # the fixed-step search's overshoot
        assert int(got[1].max()) == args[0].shape[0] + 1


@pytest.mark.parametrize("n,valid,tile", [(512, 450, 256), (3584, 3300, 256),
                                          (65536, 62400, 256),
                                          (1024, 900, 128)])
def test_k1_rows_per_block_matches_plain(cuda, n, valid, tile):
    """K1 over the pass's starts, with whole tiles per block at the big
    plans and split tiles at the small ones, equals its plain version."""
    table, _ = level(10, n=n, valid=valid, extent=48, batches=8)
    offs = sk.kernel_offsets(3, 1)
    args = starts_args(table, None, offs, tile, 512, 2, device=cuda)
    starts = K.window_starts(*args)[0]
    hi, lo, _, _, _, _, deltas, tile, window, blocks = args
    mask = table[1].to(cuda)
    rows = K.match.rows_per_block(starts.shape[1], tile, len(deltas))
    assert (rows < tile) == (n <= 3584)
    margs = (hi, lo, hi, lo, mask, deltas, starts, tile, window, blocks)
    got = K.window_match(*margs)
    assert torch.equal(got, K.window_match_plain(*margs))
    assert (got >= 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout", [(27, 20), (8, 64), (200, 96)])
def test_k2_matches_plain(cuda, dtype, c, cout):
    (coords, mask), _ = level(4, n=480, valid=420)
    plan = wc.build_plan_direct(coords, mask, sk.kernel_offsets(3, 1),
                                tile=32, window=32, blocks=4)
    g, nt, m, tile = plan.idx.shape
    assert (nt * tile) % 64  # a ragged last 64-row block
    rng = np.random.default_rng(5)
    idx = plan.idx.clone()
    idx[1, :, 2, :] = -1  # a member with no entry anywhere
    idx[:, -1, :, -4:] = 127  # ranks past the table read as zero rows
    feats = torch.as_tensor(rng.normal(size=(len(coords), c)),
                            dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(g, m, c, cout)) * 0.1,
                        dtype=torch.float32)
    f, ww = feats.to(dtype), w.to(dtype)
    want = K.window_gather_matmul_plain(f.float(), plan.starts, idx,
                                        ww.float())
    got = K.window_gather_matmul(f.to(cuda), plan.starts.to(cuda),
                                 idx.contiguous().to(cuda),
                                 ww.contiguous().to(cuda))
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float().cpu(), want, rtol=2 ** -8,
                                   atol=1e-5)


def test_conv_and_model_on_card_match_cpu(cuda):
    """The conv forward with escapes, and a small Res16UNet's eval logits,
    on the card against the CPU (f32), with both kernels launched."""
    from nerf_downstream_tpu_torch import convert, serve
    from nerf_downstream_tpu_torch.data import synthetic
    from nerf_downstream_tpu_torch.models import get_model

    (coords, mask), _ = level(6)
    offs = sk.kernel_offsets(3, 1)
    kw = dict(tile=32, window=16, blocks=2, escape_cap=4096,
              escape_tiles=200)
    rng = np.random.default_rng(7)
    feats = torch.as_tensor(rng.normal(size=(len(coords), 12)),
                            dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(27, 12, 16)) * 0.1,
                        dtype=torch.float32)
    outs = []
    for dev in ("cpu", cuda):
        plan = wc.build_plan_direct(coords.to(dev), mask.to(dev), offs, **kw)
        outs.append(wc.window_conv_apply(
            feats.to(dev), plan, wc.transpose_plan(plan, offs), w.to(dev)))
    torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=1e-5, atol=1e-5)

    knobs = dict(method="hybrid", level_caps=(1024, 512, 256, 128, 64),
                 window_tile=64,
                 window_size=32, window_blocks=2, window_expand_factor=3,
                 window_escape_cap=(8192, 2048, 256, 0, 0),
                 window_escape_tiles=(144, 72, 36, 2, 2))
    model = get_model("Res16UNet14", in_channel=27, out_channel=20,
                      planes=(8,) * 8, ctx=knobs, assume_unique=True)
    convert.load_flax_variables(model, convert.init_flax_variables(model, 0))
    srng = np.random.default_rng(0)
    samples = []
    for _ in range(2):
        sc = synthetic.make_synthetic_scene(
            srng, n_voxels=440, reso=(32, 32, 32), with_labels=True,
            surface=True)
        samples.append({
            "coordinates": sc["coords"].astype(np.float32),
            "features": np.concatenate([sc["density"], sc["sh"]],
                                       1)[:, 1:28].astype(np.float32),
            "labels": sc["labels"]})
    batch = synthetic.collate_mink(samples, capacity=1024)
    ref, ref_m = serve.eval_step(model.eval(), batch)
    K.reset_launch_counts()
    got, got_m = serve.eval_step(model.to(cuda), batch)
    counts = K.launch_counts()
    assert counts["window_match"] > 0 and counts["window_gather_matmul"] > 0
    valid = torch.as_tensor(batch["mask"])
    assert torch.isfinite(ref[valid]).all()
    torch.testing.assert_close(got.cpu()[valid], ref[valid], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(got_m["hist"].cpu(), ref_m["hist"])


def test_wrappers_refuse_bad_inputs_on_card(cuda):
    f = torch.zeros(64, 8, device=cuda)
    starts = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    idx = torch.full((1, 2, 1, 32), -1, dtype=torch.int32, device=cuda)
    w = torch.zeros(1, 1, 8, 4, device=cuda)
    assert not K.window_gather_matmul(f, starts, idx, w).any()
    with pytest.raises(TypeError):
        K.window_gather_matmul(f.double(), starts, idx, w.double())
    with pytest.raises(TypeError):
        K.window_gather_matmul(f, starts.long(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        K.window_gather_matmul(f, starts, idx, w.transpose(2, 3).contiguous()
                               .transpose(2, 3))
    with pytest.raises(ValueError, match="is on"):
        K.window_gather_matmul(f, starts.cpu(), idx, w)


def _bwd_case(dtype, c, cout, n, valid, extent):
    """K3 and K4 inputs over a same-set plan and its transpose, with a
    member emptied and ranks past the table, in ``dtype`` on the CPU."""
    (coords, mask), _ = level(8, n=n, valid=valid, extent=extent)
    offs = sk.kernel_offsets(3, 1)
    # windows wide enough that nothing escapes: the plan and its transpose
    # then hold the same pairs
    plan = wc.build_plan_direct(coords, mask, offs, tile=32, window=128,
                                blocks=6)
    assert int(plan.n_escaped) == 0
    inv = wc.transpose_plan(plan, offs)
    g, nt, m, tile = plan.idx.shape
    rng = np.random.default_rng(9)

    def rand(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale,
                               dtype=torch.float32).to(dtype)

    idx, inv_idx = plan.idx.clone(), inv.idx.clone()
    idx[1, :, 2, :] = -1
    inv_idx[2, :, 0, :] = -1
    idx[:, -1, :, -4:] = 767
    inv_idx[:, -1, :, -4:] = 767
    return dict(plan=plan, inv=inv, idx=idx, inv_idx=inv_idx,
                feats=rand(n, c), g_out=rand(n, cout),
                w_t=rand(g, m, cout, c, scale=0.1))


def _close_to_max(got, want, tol=1e-5):
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout,n,valid,extent", [
    (27, 32, 480, 420, 12), (96, 96, 480, 420, 12), (256, 200, 480, 420, 12),
    (40, 24, 4160, 3900, 14)])
def test_k3_k4_match_plain(cuda, dtype, c, cout, n, valid, extent):
    """The last case has 4,160 rows: d_w is reduced over three row
    chunks."""
    k = _bwd_case(dtype, c, cout, n, valid, extent)
    inv, plan = k["inv"], k["plan"]
    up = [x.float() for x in (k["g_out"], k["feats"], k["w_t"])]
    want_f, want_w = K.window_bwd_plain(up[0], up[1], inv.starts,
                                        k["inv_idx"], up[2])
    args = [t.contiguous().to(cuda) for t in (
        k["g_out"], k["feats"], inv.starts, k["inv_idx"], k["w_t"])]
    got_f, got_w = K.window_bwd(*args)
    assert got_f.dtype == dtype and got_w.dtype == torch.float32
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(got_f.float().cpu(), want_f, rtol=rtol,
                               atol=1e-5)
    _close_to_max(got_w, want_w)
    again_f, again_w = K.window_bwd(*args)
    assert torch.equal(again_w, got_w) and torch.equal(again_f, got_f)

    want4 = K.window_dw_plain(up[1], plan.starts, k["idx"], up[0])
    args4 = [t.contiguous().to(cuda) for t in (
        k["feats"], plan.starts, k["idx"], k["g_out"])]
    got4 = K.window_dw(*args4)
    _close_to_max(got4, want4)
    assert torch.equal(K.window_dw(*args4), got4)
    # unmodified plans: K3's d_w over the inverse plan is K4's over the
    # forward plan
    _, dw3 = K.window_bwd(args[0], args[1], args[2],
                          inv.idx.contiguous().to(cuda), args[4])
    dw4 = K.window_dw(args4[0], args4[1], plan.idx.contiguous().to(cuda),
                      args4[3])
    _close_to_max(dw3, dw4.cpu())


def test_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One f32 training step of a small Res16UNet14 (device augmentation
    off: the two devices' generators draw different numbers) on the card
    against the CPU, with K1-K4 launched."""
    from nerf_downstream_tpu_torch import train3d
    from nerf_downstream_tpu_torch.data import synthetic

    knobs = dict(method="hybrid", level_caps=(1024, 512, 256, 128, 64),
                 window_tile=64,
                 window_size=32, window_blocks=2, window_expand_factor=3,
                 window_escape_cap=(8192, 2048, 256, 0, 0),
                 window_escape_tiles=(144, 72, 36, 2, 2))
    monkeypatch.setitem(train3d.PRESETS, "tiny", dict(
        train3d.PRESETS["train_64k"], scenes=2, capacity=1024, ctx=knobs,
        grid_extent=40,
        task=dict(train3d.PRESETS["train_64k"]["task"],
                  device_transforms=())))
    srng = np.random.default_rng(0)
    samples = []
    for _ in range(2):
        sc = synthetic.make_synthetic_scene(
            srng, n_voxels=440, reso=(32, 32, 32), with_labels=True,
            surface=True)
        samples.append({
            "coordinates": sc["coords"].astype(np.float32),
            "features": np.concatenate([sc["density"], sc["sh"]],
                                       1)[:, 1:28].astype(np.float32),
            "labels": sc["labels"]})
    batch = synthetic.collate_mink(samples, capacity=1024)
    runs = []
    for dev in ("cpu", cuda):
        task, state = train3d.build_training(
            "Res16UNet14", "tiny", device=dev, planes=(8,) * 8,
            compute_dtype=torch.float32)
        K.reset_launch_counts()
        state, mets = train3d.train_step(task, state, batch)
        runs.append((float(mets["loss"]), K.launch_counts(),
                     {k: p.grad.cpu() for k, p in
                      state.model.named_parameters()}))
    (loss_c, _, grads_c), (loss_g, counts, grads_g) = runs
    assert np.isfinite(loss_c)
    assert all(counts[k] > 0 for k in ("window_match", "window_gather_matmul",
                                       "window_bwd", "window_dw")), counts
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-5)
    for key, g in grads_c.items():
        _close_to_max(grads_g[key], g, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,c,cout", [(4, 27, 20), (16, 40, 72),
                                          (128, 200, 264)])
def test_k5_matches_plain(cuda, dtype, block, c, cout):
    """K5 at granularities 4, 16 and 128 with ragged channels: half the
    blocks dead, a member emptied in the spec and another in the plan, and
    a spec that also kills blocks whose weights are not zero. Against its
    plain version, equal to K2 on the spec-masked weights bit for bit (in
    bf16 both run the tensor cores with K2's tile and split; a step K5
    skips adds exact zeros in K2), and equal to itself given those
    weights with ``masked=True``."""
    (coords, mask), _ = level(10, n=480, valid=420)
    plan = wc.build_plan_direct(coords, mask, sk.kernel_offsets(3, 1),
                                tile=32, window=32, blocks=4)
    g, nt, m, tile = plan.idx.shape
    rng = np.random.default_rng(11)
    nbi, nbo = -(-c // block), -(-cout // block)
    live = torch.as_tensor(rng.random((g, m, nbi, nbo)) < 0.5,
                           dtype=torch.uint8)
    live[0, 1] = 0  # a member with no live pair
    idx = plan.idx.clone()
    idx[2, :, 0, :] = -1  # a member with no entry
    feats = torch.as_tensor(rng.normal(size=(len(coords), c)),
                            dtype=torch.float32).to(dtype)
    w = torch.as_tensor(rng.normal(size=(g, m, c, cout)) * 0.1,
                        dtype=torch.float32).to(dtype)
    want = K.window_gather_matmul_bs_plain(feats.float(), plan.starts, idx,
                                           w.float(), live, block)
    args = [t.contiguous().to(cuda) for t in (feats, plan.starts, idx, w,
                                              live)]
    K.reset_launch_counts()
    got = K.window_gather_matmul_bs(*args, block)
    assert K.launch_counts()["window_gather_matmul_bs"] == 1
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float().cpu(), want, rtol=2 ** -8,
                                   atol=1e-5)
    assert torch.equal(K.window_gather_matmul_bs(*args, block), got)
    masked = args[3] * K.gather_matmul_bs.live_mask(
        args[4], block, c, cout).to(dtype)
    k2 = K.window_gather_matmul(args[0], args[1], args[2],
                                masked.contiguous())
    if dtype == torch.float32:  # both on the CUDA-core core
        torch.testing.assert_close(got.float(), k2.float(), rtol=1e-6,
                                   atol=1e-6)
    else:  # both on the tensor cores, same tile, split and order
        assert torch.equal(got, k2)
    # weights the caller keeps masked: the same answer, bit for bit
    assert torch.equal(K.window_gather_matmul_bs(
        *args[:3], masked.contiguous(), args[4], block, masked=True), got)
    # the dead blocks really held weights: the dense answer differs
    dense = K.window_gather_matmul(*args[:4])
    assert not torch.allclose(dense.float(), got.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 8, 27])
def test_k6_matches_plain(cuda, dtype, k):
    """K6 at ragged N_out, Cin and Cout with a third of the entries
    sentinels and one offset all sentinels; bf16 inputs give f32 output."""
    rng = np.random.default_rng(12 + k)
    n_in, n_out, c, cout = 700, 333, 40, 72
    x = torch.as_tensor(rng.normal(size=(n_in + 1, c)),
                        dtype=torch.float32)
    x[-1] = 0
    km = torch.as_tensor(rng.integers(0, n_in, (k, n_out)),
                         dtype=torch.int32)
    km[torch.as_tensor(rng.random((k, n_out)) < 0.33)] = n_in
    km[0] = n_in
    w = torch.as_tensor(rng.normal(size=(k, c, cout)) * 0.1,
                        dtype=torch.float32)
    x, w = x.to(dtype), w.to(dtype)
    want = K.row_gather_matmul_plain(x.float(), km, w.float())
    args = [t.contiguous().to(cuda) for t in (x, km, w)]
    got = K.row_gather_matmul(*args)
    assert got.dtype == torch.float32 and got.shape == (n_out, cout)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(K.row_gather_matmul(*args), got)
    empty = torch.full_like(args[1], n_in)
    assert not K.row_gather_matmul(args[0], empty, args[2]).any()


# the row path's shapes at eval_64k: (N_in, N_out, C = Cout) of the four
# down convs of Res16UNet18A
ROW_SHAPES = [(65536, 14848, 32), (14848, 3584, 32), (3584, 1024, 64),
              (1024, 512, 128)]


def k6_inputs(seed, n_in, n_out, c, cout, k, sentinels=0.4):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n_in + 1, c)), dtype=torch.float32)
    x[-1] = 0
    km = torch.as_tensor(rng.integers(0, n_in, (k, n_out)), dtype=torch.int32)
    km[torch.as_tensor(rng.random((k, n_out)) < sentinels)] = n_in
    w = torch.as_tensor(rng.normal(size=(k, c, cout)) * 0.1,
                        dtype=torch.float32)
    return x.to(torch.bfloat16), km, w.to(torch.bfloat16)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("n_in,n_out,c", ROW_SHAPES)
def test_k6_tc_matches_plain_at_row_path_shapes(cuda, n_in, n_out, c, k):
    """bf16 K6 on the tensor cores, with its (term, chunk) split where the
    grid is small, against the plain f32 sum within atol = rtol = 1e-5,
    and bit-identical on repeat."""
    x, km, w = (t.to(cuda) for t in k6_inputs(20 + k, n_in, n_out, c, c, k))
    choice = K.tc.row_choice(x.dtype, n_out, c, c, k, K.tc.aligned(x, w))
    assert choice.core == "tensor" and choice.vec
    assert (choice.parts > 1) == (n_out < 14848)
    got = K.row_gather_matmul(x, km, w)
    want = K.row_gather_matmul_plain(x.float(), km, w.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(K.row_gather_matmul(x, km, w), got)


def test_k6_tc_nan_row_reaches_the_rows_that_name_it(cuda):
    """A NaN input row reaches exactly the output rows whose map names it,
    through the split's partials, as in the plain version."""
    x, km, w = k6_inputs(30, 1024, 512, 128, 128, 4)
    x[7, 3] = float("nan")
    km[2, :40] = 7
    x, km, w = (t.to(cuda) for t in (x, km, w))
    assert K.tc.row_choice(x.dtype, 512, 128, 128, 4).parts > 1
    got = K.row_gather_matmul(x, km, w)
    want = K.row_gather_matmul_plain(x.float(), km, w.float())
    nan_rows = (km == 7).any(0)
    assert torch.equal(torch.isnan(got), nan_rows[:, None].expand_as(got))
    assert torch.equal(torch.isnan(want), torch.isnan(got))
    torch.testing.assert_close(got[~nan_rows], want[~nan_rows], rtol=1e-5,
                               atol=1e-5)


def test_k6_tc_misaligned_input_takes_element_staging(cuda):
    """x_ext starting off a 16-byte boundary goes through the element
    staging (32-column tile) and still matches the plain version."""
    x, km, w = k6_inputs(31, 3584, 1024, 64, 64, 2)
    buf = torch.zeros(x.numel() + 8, dtype=torch.bfloat16, device=cuda)
    xm = buf[1:1 + x.numel()].view(x.shape)
    xm.copy_(x.to(cuda))
    km, w = km.to(cuda), w.to(cuda)
    assert not K.tc.aligned(xm)
    choice = K.tc.row_choice(xm.dtype, 1024, 64, 64, 2, K.tc.aligned(xm, w))
    assert not choice.vec and choice.column_tile == 32
    got = K.row_gather_matmul(xm, km, w)
    want = K.row_gather_matmul_plain(xm.float(), km, w.float())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(K.row_gather_matmul(xm, km, w), got)


def test_k5_k6_refuse_bad_inputs_on_card(cuda):
    f = torch.zeros(64, 8, device=cuda)
    starts = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    idx = torch.full((1, 2, 1, 32), -1, dtype=torch.int32, device=cuda)
    w = torch.zeros(1, 1, 8, 4, device=cuda)
    live = torch.ones(1, 1, 2, 1, dtype=torch.uint8, device=cuda)
    assert not K.window_gather_matmul_bs(f, starts, idx, w, live, 4).any()
    with pytest.raises(ValueError, match="live"):
        K.window_gather_matmul_bs(f, starts, idx, w, live, 8)
    with pytest.raises(TypeError):
        K.window_gather_matmul_bs(f, starts, idx, w, live.bool(), 4)
    km = torch.zeros(2, 16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        K.row_gather_matmul(f, km.long(), torch.zeros(2, 8, 4, device=cuda))
    with pytest.raises(ValueError, match="w"):
        K.row_gather_matmul(f, km, torch.zeros(3, 8, 4, device=cuda))


@pytest.mark.parametrize("case", ["zaxis", "offsets", "blocks"])
def test_sparse_eval_on_card_matches_cpu(cuda, monkeypatch, case):
    """A small Res16UNet14 in the pruned-eval modes, f32 on the card
    against the CPU: ZAXIS (down convs on the row path, K6), pruned
    offsets (padded subsets and K6) and pruned 4x4 blocks (K5)."""
    from nerf_downstream_tpu_torch import convert, eval3d, serve
    from nerf_downstream_tpu_torch.data import synthetic
    from nerf_downstream_tpu_torch.utils import prune

    knobs = dict(method="hybrid", level_caps=(1024, 512, 256, 128, 64),
                 window_tile=64,
                 window_size=256, window_blocks=4, window_expand_factor=3,
                 window_escape_tiles=(144, 72, 36, 2, 2))
    monkeypatch.setitem(serve.PRESETS, "tiny", dict(
        scenes=2, capacity=1024, grid_extent=64, assume_unique=True,
        ctx=knobs))
    dense = eval3d.get_model("Res16UNet14", in_channel=27, out_channel=20,
                             planes=(8,) * 8)
    variables = convert.init_flax_variables(dense, 5)
    flat = prune.flatten(variables["params"])
    rng = np.random.default_rng(13)
    for path, arr in flat.items():
        if path[-1] != "kernel" or arr.shape[0] == 1:
            continue
        if case == "offsets":
            keep = (0, 3, 4, 7) if arr.shape[0] == 8 else (0, 1, 4, 13, 22)
            out = np.zeros_like(arr)
            out[list(keep)] = arr[list(keep)]
            flat[path] = out
        elif case == "blocks":
            dead = rng.random((arr.shape[0], -(-arr.shape[1] // 4),
                               -(-arr.shape[2] // 4))) < 0.5
            mask = dead.repeat(4, 1).repeat(4, 2)[:, :arr.shape[1],
                                                  :arr.shape[2]]
            flat[path] = np.where(mask, 0, arr).astype(arr.dtype)
    variables["params"] = prune.unflatten(flat)
    mode = 2 if case == "zaxis" else 1
    layout = "csr" if case == "blocks" else "strided"
    vmap, bmap = eval3d.derive_maps(variables["params"], [mode] * 9, layout,
                                    granularity=4)
    srng = np.random.default_rng(0)
    samples = []
    for _ in range(2):
        sc = synthetic.make_synthetic_scene(
            srng, n_voxels=440, reso=(32, 32, 32), with_labels=True,
            surface=True)
        samples.append({
            "coordinates": sc["coords"].astype(np.float32),
            "features": np.concatenate([sc["density"], sc["sh"]],
                                       1)[:, 1:28].astype(np.float32),
            "labels": sc["labels"]})
    batch = synthetic.collate_mink(samples, capacity=1024)
    outs, routes = [], []
    for dev in ("cpu", cuda):
        model = eval3d.build_evaluator(
            "tiny", variables, sparse_mode=[mode] * 9,
            valid_offsets_map=vmap, block_live_map=bmap,
            block_live_granularity=4, device=dev,
            compute_dtype=torch.float32, model="Res16UNet14",
            planes=(8,) * 8)
        K.reset_launch_counts()
        outs.append(serve.eval_step(model, batch)[0].cpu())
        routes.append(eval3d.route_counts(model))
    counts = K.launch_counts()
    want = {"zaxis": "row_gather_matmul", "offsets": "row_gather_matmul",
            "blocks": "window_gather_matmul_bs"}[case]
    assert counts[want] > 0
    assert routes[0] == routes[1]
    valid = torch.as_tensor(batch["mask"])
    assert torch.isfinite(outs[0][valid]).all()
    torch.testing.assert_close(outs[1][valid], outs[0][valid], rtol=1e-4,
                               atol=1e-4)


def _tc_plan(seed, n_out, n_rows, g=9, m=3, tile=32, window=96):
    """A random window plan on the CPU: int32 starts [G, nT] and idx
    [G, nT, M, T] with a third of the entries absent, the first 64 rows
    (one block of the core) all absent, and some ranks of the last tile
    past the table."""
    rng = np.random.default_rng(seed)
    nt = -(-n_out // tile)
    starts = np.sort(rng.integers(0, max(n_rows - window // 2, 1), (g, nt)),
                     axis=1)
    idx = rng.integers(0, window, (g, nt, m, tile))
    idx[rng.random(idx.shape) < 0.33] = -1
    idx[:, :64 // tile] = -1
    starts[:, -1] = n_rows - 8
    idx[:, -1, :, :5] = 40  # rows n_rows + 32: past the table
    return (torch.as_tensor(starts, dtype=torch.int32),
            torch.as_tensor(idx, dtype=torch.int32))


def _tc_inputs(seed, n_rows, c, cout, g=9, m=3):
    rng = np.random.default_rng(seed)
    feats = torch.as_tensor(rng.normal(size=(n_rows, c)),
                            dtype=torch.float32).to(torch.bfloat16)
    w = torch.as_tensor(rng.normal(size=(g, m, c, cout)) / np.sqrt(g * m * c),
                        dtype=torch.float32).to(torch.bfloat16)
    return feats, w


# (rows, C, Cout): row counts that are not a multiple of the core's 64
# (23 and 31 tiles of 32) at every column tile, the C = 27 stem's element
# staging, the split on (512 rows, Cout 256) and off (65,536 rows)
TC_CASES = [(720, 27, 96), (720, 32, 256), (720, 96, 96), (720, 256, 96),
            (990, 27, 256), (990, 96, 256), (512, 256, 256),
            (512, 32, 96), (65536, 32, 96)]


@pytest.mark.parametrize("n_out,c,cout", TC_CASES)
def test_k2_tc_matches_plain(cuda, n_out, c, cout):
    from nerf_downstream_tpu_torch.ops.kernels import tc

    n_rows = n_out + 37
    starts, idx = _tc_plan(20 + c, n_out, n_rows)
    feats, w = _tc_inputs(21 + cout, n_rows, c, cout)
    args = [t.contiguous().to(cuda) for t in (feats, starts, idx, w)]
    want = K.window_gather_matmul_plain(args[0].float(), args[1], args[2],
                                        args[3].float())
    K.reset_launch_counts()
    got = K.window_gather_matmul(*args)
    assert K.launch_counts()["window_gather_matmul"] == 1
    n_pad = idx.shape[1] * idx.shape[3]
    choice = tc.gather_choice(torch.bfloat16, n_pad, c, cout, 27)
    assert (choice.parts > 1) == (n_out < 65536)
    assert got.dtype == torch.bfloat16 and got.shape == (n_pad, cout)
    assert not got[:64].any()  # the all-absent block
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-5)
    assert torch.equal(K.window_gather_matmul(*args), got)


@pytest.mark.parametrize("n_in,c,cout", [(720, 27, 96), (720, 96, 96),
                                          (990, 256, 32), (512, 256, 256),
                                          (65536, 96, 32)])
def test_k3_tc_matches_plain(cuda, n_in, c, cout):
    """Both halves of K3 in bf16 against the f32 plain version: d_feats as
    K2, d_w within 1e-5 of its largest; repeats bit-identical."""
    n_out = n_in + 21
    inv_starts, inv_idx = _tc_plan(30 + c, n_in, n_out)
    rng = np.random.default_rng(31 + cout)
    g_out = torch.as_tensor(rng.normal(size=(n_out, cout)),
                            dtype=torch.float32).to(torch.bfloat16)
    n_pad = inv_idx.shape[1] * inv_idx.shape[3]
    feats = torch.as_tensor(rng.normal(size=(n_pad, c)),
                            dtype=torch.float32).to(torch.bfloat16)
    w_t = torch.as_tensor(rng.normal(size=(9, 3, cout, c)) * 0.1,
                          dtype=torch.float32).to(torch.bfloat16)
    args = [t.contiguous().to(cuda) for t in (g_out, feats, inv_starts,
                                              inv_idx, w_t)]
    want_f, want_w = K.window_bwd_plain(
        args[0].float(), args[1].float(), args[2], args[3], args[4].float())
    K.reset_launch_counts()
    got_f, got_w = K.window_bwd(*args)
    assert K.launch_counts()["window_bwd"] == 1
    assert got_f.dtype == torch.bfloat16 and got_w.dtype == torch.float32
    torch.testing.assert_close(got_f.float(), want_f, rtol=2 ** -8,
                               atol=1e-5)
    _close_to_max(got_w.cpu(), want_w.cpu())
    again_f, again_w = K.window_bwd(*args)
    assert torch.equal(again_f, got_f) and torch.equal(again_w, got_w)


@pytest.mark.parametrize("n_out,cout", [(512, 256), (720, 96)])
def test_tc_nan_row_reaches_its_outputs(cuda, n_out, cout):
    """A NaN input row poisons exactly the output rows whose plan names
    it (K2, split on at 512 x 256) and, in K3, the d_feats rows and the
    d_w slices of the members that name it."""
    c = 64
    n_rows = n_out + 37
    starts, idx = _tc_plan(40, n_out, n_rows)
    feats, w = _tc_inputs(41, n_rows, c, cout)
    rows = starts[:, :, None, None].long() + idx.long()
    present = (idx >= 0) & (rows < n_rows)
    bad = int(rows[present][0])
    feats[bad] = float("nan")
    names = (present & (rows == bad))  # [G, nT, M, T]
    want_rows = names.any(2).any(0).reshape(-1)
    args = [t.contiguous().to(cuda) for t in (feats, starts, idx, w)]
    got = K.window_gather_matmul(*args)
    assert torch.equal(torch.isnan(got).any(1).cpu(), want_rows)
    assert torch.equal(torch.isnan(got).all(1).cpu(), want_rows)

    # K3 with the same plan as its inverse plan and g_out = feats
    n_in = idx.shape[1] * idx.shape[3]
    x = torch.ones(n_in, cout, dtype=torch.bfloat16, device=cuda)
    d_f, d_w = K.window_bwd(args[0], x, args[1], args[2], args[3])
    assert torch.equal(torch.isnan(d_f).any(1).cpu(), want_rows)
    want_w = names.any(3).any(1)  # [G, M]
    assert torch.equal(torch.isnan(d_w).flatten(2).any(2).cpu(), want_w)
    assert torch.equal(torch.isnan(d_w).flatten(2).all(2).cpu(), want_w)


def test_tc_refuses_misaligned_rows(cuda):
    """The 16-byte copies need 16-byte aligned rows: a bf16 tensor that
    starts 2 bytes into its storage is refused, not read askew."""
    buf = torch.zeros(64 * 8 + 8, dtype=torch.bfloat16, device=cuda)
    f = buf[1:513].view(64, 8)
    starts = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    idx = torch.full((1, 2, 1, 32), -1, dtype=torch.int32, device=cuda)
    w = torch.zeros(1, 1, 8, 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="boundary"):
        K.window_gather_matmul(f, starts, idx, w)
    assert not K.window_gather_matmul(buf[8:520].view(64, 8), starts, idx,
                                      w).any()


def _k5_spec(seed, g, m, c, cout, block, dead=0.5):
    """A random liveness spec with ``dead`` of the blocks dead and member
    (0, 1) dead in full."""
    rng = np.random.default_rng(seed)
    live = torch.as_tensor(
        rng.random((g, m, -(-c // block), -(-cout // block))) >= dead,
        dtype=torch.uint8)
    live[0, 1] = 0
    return live


# (rows, C, Cout, granularity): the term split on (512 x 256, 990 x 128)
# and off (16,384 rows), granularities 4, 16, 32 and 128, Cout = 96 (one
# 96-column tile), the element staging of C = 27
K5_TC_CASES = [(512, 256, 256, 32), (512, 256, 256, 128), (990, 128, 128, 16),
               (720, 96, 96, 32), (720, 96, 96, 4), (16384, 96, 96, 32),
               (720, 40, 72, 16), (720, 27, 20, 4), (990, 128, 256, 128)]


@pytest.mark.parametrize("n_out,c,cout,block", K5_TC_CASES)
def test_k5_tc_equals_k2_on_masked_weights(cuda, n_out, c, cout, block):
    """K5 in bf16 (tensor cores, K2's column tile and term split) equals
    K2's bf16 output on the spec-masked weights bit for bit, with a member
    dead in the spec and another absent from the plan; within 2^-8 of the
    f32 plain version; repeats bit-identical; the same given weights
    already masked."""
    from nerf_downstream_tpu_torch.ops.kernels import tc

    n_rows = n_out + 37
    starts, idx = _tc_plan(50 + block, n_out, n_rows)
    idx[2, :, 0, :] = -1  # member (2, 0) absent from the plan
    feats, w = _tc_inputs(51 + c, n_rows, c, cout)
    live = _k5_spec(52 + cout, 9, 3, c, cout, block)
    args = [t.contiguous().to(cuda) for t in (feats, starts, idx, w, live)]
    want = K.window_gather_matmul_bs_plain(
        args[0].float(), args[1], args[2], args[3].float(), args[4], block)
    K.reset_launch_counts()
    got = K.window_gather_matmul_bs(*args, block)
    assert K.launch_counts()["window_gather_matmul_bs"] == 1
    n_pad = idx.shape[1] * idx.shape[3]
    choice = tc.gather_choice(torch.bfloat16, n_pad, c, cout, 27)
    assert choice.core == "tensor"
    assert (choice.parts > 1) == (n_out < 16384)
    assert got.dtype == torch.bfloat16 and got.shape == (n_pad, cout)
    masked = (args[3] * K.gather_matmul_bs.live_mask(
        args[4], block, c, cout).to(torch.bfloat16)).contiguous()
    k2 = K.window_gather_matmul(*args[:3], masked)
    assert torch.equal(got, k2)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-5)
    assert torch.equal(K.window_gather_matmul_bs(*args, block), got)
    assert torch.equal(K.window_gather_matmul_bs(*args[:3], masked, args[4],
                                                 block, masked=True), got)
    # a spec with nothing live gives zeros; one with everything live, K2
    none = torch.zeros_like(args[4])
    assert not K.window_gather_matmul_bs(*args[:4], none, block).any()
    assert torch.equal(K.window_gather_matmul_bs(
        *args[:4], torch.ones_like(args[4]), block),
        K.window_gather_matmul(*args[:4]))


@pytest.mark.parametrize("n_out,c,cout,block", [(512, 256, 256, 128),
                                                (720, 64, 32, 32)])
def test_k5_tc_nan_row_reaches_live_blocks_only(cuda, n_out, c, cout,
                                                block):
    """At a granularity that is a multiple of the 32-channel step and of
    the column tile, a NaN input row reaches exactly the outputs that a
    live block multiplies it into (the rows whose plan names it, the
    columns of the live blocks of the naming members), through the split
    (512 x 256) too, and nothing through a dead block."""
    from nerf_downstream_tpu_torch.ops.kernels import tc

    assert block % tc.column_tile(c, cout) == 0
    n_rows = n_out + 37
    starts, idx = _tc_plan(60, n_out, n_rows)
    feats, w = _tc_inputs(61, n_rows, c, cout)
    live = _k5_spec(62, 9, 3, c, cout, block)
    rows = starts[:, :, None, None].long() + idx.long()
    present = (idx >= 0) & (rows < n_rows)
    bad = int(rows[present][0])
    feats[bad] = float("nan")
    names = (present & (rows == bad)).permute(0, 2, 1, 3).reshape(
        9, 3, -1)  # [G, M, rows]
    cols = live.bool().any(2).repeat_interleave(block, -1)[..., :cout]
    want = (names[..., :, None] & cols[..., None, :]).flatten(0, 1).any(0)
    args = [t.contiguous().to(cuda) for t in (feats, starts, idx, w, live)]
    got = K.window_gather_matmul_bs(*args, block)
    assert want.any() and not want.all()
    assert torch.equal(torch.isnan(got).cpu(), want)


def test_k5_tc_refuses_misaligned_rows(cuda):
    """bf16 K5 copies 16-byte pieces: rows that start 2 bytes into their
    storage are refused, not read askew."""
    buf = torch.zeros(64 * 8 + 8, dtype=torch.bfloat16, device=cuda)
    starts = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    idx = torch.full((1, 2, 1, 32), -1, dtype=torch.int32, device=cuda)
    w = torch.zeros(1, 1, 8, 8, dtype=torch.bfloat16, device=cuda)
    live = torch.ones(1, 1, 1, 1, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="boundary"):
        K.window_gather_matmul_bs(buf[1:513].view(64, 8), starts, idx, w,
                                  live, 8)
    assert not K.window_gather_matmul_bs(buf[8:520].view(64, 8), starts,
                                         idx, w, live, 8).any()


def _close_per_slice(got, want, tol=1e-5):
    """Every [C, Cout] slice of d_w within tol of its largest value."""
    d = (got.cpu() - want.cpu()).abs().flatten(-2).amax(-1)
    scale = want.cpu().abs().flatten(-2).amax(-1)
    assert bool((d <= tol * scale).all()), (d / scale).max()


@pytest.mark.parametrize("c,cout", [(27, 32), (27, 96), (96, 32)])
def test_k4_tc_matches_plain(cuda, c, cout):
    """K4 in bf16 over 65,536 rows (the stem's row count, so d_w is summed
    over many row chunks), the stem's C = 27 with element staging among
    them: within 1e-5 of the largest value of each (g, m) of the f32 plain
    version on the same inputs, repeats bit-identical."""
    from nerf_downstream_tpu_torch.ops.kernels import tc

    n_out = 65536
    n_rows = n_out + 37
    starts, idx = _tc_plan(70 + c, n_out, n_rows)
    idx[1, :, 2, :] = -1  # a member with no entry
    feats, _ = _tc_inputs(71 + cout, n_rows, c, 8)
    rng = np.random.default_rng(72)
    g_out = torch.as_tensor(rng.normal(size=(n_out, cout)),
                            dtype=torch.float32).to(torch.bfloat16)
    args = [t.contiguous().to(cuda) for t in (feats, starts, idx, g_out)]
    choice = tc.dw_choice(torch.bfloat16, n_out, c, cout, 27)
    assert choice.core == "tensor" and choice.chunks(n_out) > 1
    want = K.window_dw_plain(args[0].float(), args[1], args[2],
                             args[3].float())
    K.reset_launch_counts()
    got = K.window_dw(*args)
    assert K.launch_counts()["window_dw"] == 1
    assert got.dtype == torch.float32 and got.shape == (9, 3, c, cout)
    assert not got[1, 2].any()
    keep = torch.ones(9, 3, dtype=torch.bool)
    keep[1, 2] = False
    _close_per_slice(got[keep], want[keep])
    assert torch.equal(K.window_dw(*args), got)


def test_two_train_8k_steps_are_bit_identical(cuda):
    """Two f32 kernel-path ``train_8k`` steps from the same fresh state
    (every accumulating scatter adds in a fixed order) give the same loss,
    gradients, updated weights and running statistics bit for bit."""
    from nerf_downstream_tpu_torch import serve, train3d

    batch = serve.to_device(
        train3d.make_batch("train_8k", np.random.default_rng(1)), cuda)
    runs = []
    for _ in range(2):
        task, state = train3d.build_training(
            "Res16UNet18A", "train_8k", device=cuda, seed=0,
            compute_dtype=torch.float32)
        state, mets = train3d.train_step(task, state, batch)
        runs.append([mets["loss"]]
                    + [p.grad for p in state.model.parameters()]
                    + [p.detach() for p in state.model.parameters()]
                    + list(state.model.buffers()))
    assert not torch.are_deterministic_algorithms_enabled()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_cli_trains_and_resumes_on_card(cuda, tmp_path):
    """The training CLI on a 3-scene synthetic tree with the flagship
    configs at full width: 2 steps, then ``--resume`` to 3; finite losses,
    the checkpoints, and the resumed run's step."""
    import json

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.co3d_3d import train as cli
    from nerf_downstream_tpu_torch.data.synthetic import write_scannet_tree
    from nerf_downstream_tpu_torch.train import checkpoints

    # one voxel per finest unit, as chip_smoke.py's tree: the config's
    # level_cap_decay overflows sparser shells in both packages
    root = write_scannet_tree(str(tmp_path), np.random.default_rng(0),
                              n_train=3, n_val=0, n_voxels=2000,
                              reso=(128, 128, 128), scene_scale=100 / 128)
    save = tmp_path / "exp"
    args = ["--ginc", "co3d_3d/configs/scannet_plenoxel.gin",
            "--ginc", "co3d_3d/configs/scannet_feature_sh.gin"]
    for b in (f'PlenoxelScannetDataset.data_root = "{root}"',
              "PlenoxelScannetDataset.downsample_stride = 1",
              "train.batch_size = 2", "train.val_batch_size = 1",
              "train.val_every_n_steps = 1", "train.log_every_n_steps = 1",
              'train.loggers = ["jsonl"]', "train.evaluate = True"):
        args += ["--ginb", b]
    args += ["--save_path", str(save)]
    try:
        for steps, extra in ((2, []), (3, ["--resume"])):
            gin.clear_config()
            cli.main(args + ["--ginb", f"train.max_steps = {steps}"] + extra)
            ck = checkpoints.load_checkpoint(str(save / "last.ckpt"))
            assert ck["global_step"] == steps
    finally:
        gin.clear_config()
    with open(save / "b2x1-Res16UNet" / "metrics.jsonl") as f:
        rows = [json.loads(ln) for ln in f]
    losses = {r["step"]: r["train/loss"] for r in rows if "train/loss" in r}
    assert sorted(losses) == [1, 2]
    assert np.isfinite(list(losses.values())).all()
    assert all(np.isfinite(r["val/loss"]) for r in rows if "val/loss" in r)
    assert (save / "best.ckpt").exists()
    assert (save / "eval_results.json").exists()


def test_resnet_step_on_card_matches_cpu(cuda):
    """A small ResNet14 (planes 8) on the card against the CPU: eval logits
    within 1e-4 x max|logit| and one classification training step's loss
    within 1e-5 relative and gradients within 1e-4 of each largest, with
    K6 (the k3/s2 convs) launched in both."""
    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.data import synthetic
    from nerf_downstream_tpu_torch.models import get_model
    from nerf_downstream_tpu_torch.train.loop import to_device
    from nerf_downstream_tpu_torch.train.modules import (
        ClassificationTraining,
    )

    knobs = dict(method="hybrid", grid_extent=64,
                 level_caps=(2048, 1024, 512, 256, 128), window_tile=64,
                 window_size=64, window_blocks=2, window_expand_factor=3,
                 window_escape_cap=(4096, 1024, 1024, 256, 256),
                 window_escape_tiles=(288, 144, 72, 36, 36))
    rng = np.random.default_rng(0)
    samples = []
    for i in range(3):
        sc = synthetic.make_synthetic_scene(rng, n_voxels=500,
                                            reso=(48, 48, 48), surface=True)
        samples.append({"coordinates": sc["coords"].astype(np.float32),
                        "features": sc["sh"].astype(np.float32),
                        "labels": np.array([i + 3], np.int32)})
    batch = synthetic.collate_mink(samples, capacity=2048)
    out = {}
    for dev in ("cpu", cuda):
        model = get_model("ResNet14", in_channel=27, out_channel=51,
                          planes=(8, 8, 8, 8), init_dim=8, num_batches=3,
                          ctx=knobs, assume_unique=True)
        convert.load_flax_variables(model,
                                    convert.init_flax_variables(model, 1))
        model.to(dev)
        task = ClassificationTraining(model, scheduler_name="none", lr=0.1)
        state = task.create_state()
        b = to_device(batch, dev)
        K.reset_launch_counts()
        logits, _ = task.eval_step(state, b)
        _, mets = task.train_step(state, b)
        out[str(dev)] = (logits.cpu(), float(mets["loss"]), {
            k: p.grad.cpu() for k, p in model.named_parameters()})
        if dev != "cpu":
            assert K.launch_counts()["row_gather_matmul"] == 8
    (l0, loss0, g0), (l1, loss1, g1) = out.values()
    assert torch.isfinite(l0).all() and np.isfinite(loss0)
    _close_to_max(l1, l0, 1e-4)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-5)
    for k in g0:
        _close_to_max(g1[k], g0[k], 1e-4)


def test_cls_cli_calibrates_and_trains_on_card(cuda, tmp_path):
    """The classification CLI at full width (ResNet14, ``co3d_aug2``) on
    the reference CLI test's tree: calibration on the card, 3 steps,
    a finite validation, the checkpoints and ``val/acc1``."""
    import json

    from nerf_downstream_tpu_torch import config as gin
    from nerf_downstream_tpu_torch.co3d_3d import train as cli
    from nerf_downstream_tpu_torch.data.synthetic import write_co3d_tree

    root, fdir = write_co3d_tree(str(tmp_path), np.random.default_rng(0),
                                 n_train=4, n_val=0, n_voxels=300,
                                 reso=(32, 32, 32), num_classes=3)
    args = []
    for c in ("co3d_cls", "co3d_aug2", "feature_sh", "resnet14"):
        args += ["--ginc", f"co3d_3d/configs/{c}.gin"]
    for b in (f'Co3DDatasetBase.data_root = "{root}"',
              f'Co3DDatasetBase.filelist_dir = "{fdir}"',
              "Co3DDatasetBase.downsample_stride = 1",
              "train.max_steps = 3", "train.val_every_n_steps = 2",
              "train.batch_size = 2", "train.val_batch_size = 2",
              "train.train_num_workers = 1", "train.val_num_workers = 1",
              "train.evaluate = True"):
        args += ["--ginb", b]
    save = tmp_path / "exp"
    try:
        gin.clear_config()
        K.reset_launch_counts()
        cli.main(args + ["--save_path", str(save), "--seed", "1"])
        assert gin.query_parameter("CoordinateContext.level_caps")
    finally:
        gin.clear_config()
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in ("window_match", "window_starts",
                                       "window_gather_matmul", "window_bwd",
                                       "row_gather_matmul"))
    res = json.load(open(save / "eval_results.json"))
    assert np.isfinite(res["val/loss"]) and "val/acc1" in res
    assert (save / "best.ckpt").exists() and (save / "last.ckpt").exists()
