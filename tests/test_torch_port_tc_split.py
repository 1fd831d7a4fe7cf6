"""The launch choices of the bf16 tensor-core path of K2-K6
(``nerf_downstream_tpu_torch/ops/kernels/tc.py``), on the CPU: the column
tile of the gather-matmul core, the split of the G x M terms over blocks
at coarse levels, the d_w tiles and row chunks, K5's launch arguments
(K2's choice), the share of its steps a liveness spec keeps, and K6's
column tile and (term, chunk) step split with its launch arguments. The
kernels themselves run on the card only
(``tests/test_torch_port_cuda.py``). Also the port's SGD against the JAX
package's (optax) where both are defined, and its refusal where they
differ (dampening with momentum)."""

import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nerf_downstream_tpu.train import optim as JO  # noqa: E402
from nerf_downstream_tpu_torch.ops import kernels as K  # noqa: E402
from nerf_downstream_tpu_torch.ops.kernels import (  # noqa: E402
    gather_matmul_bs,
    row_gather,
    tc,
)
from nerf_downstream_tpu_torch.train import optim as TO  # noqa: E402

# (rows, Cout, terms): the Res16UNet18A levels of the 64k batches (65,536,
# 14,848, 3,584, 1,024 and 512 rows) at their widths, a 2x2x2 conv's 8
# terms, and edge cases
SHAPES = [(65536, 96, 27), (65536, 32, 27), (14848, 64, 27), (14848, 64, 8),
          (3584, 128, 27), (1024, 256, 27), (512, 256, 27), (512, 256, 8),
          (512, 96, 1), (64, 20, 27), (1, 8, 27), (0, 32, 27),
          (131072, 384, 125)]


@pytest.mark.parametrize("n_out,cout,n_terms", SHAPES)
def test_term_split_covers_every_term_once(n_out, cout, n_terms):
    bn = tc.column_tile(96, cout)
    parts, per = tc.term_split(n_out, cout, n_terms, bn)
    assert (parts, per) == tc.term_split(n_out, cout, n_terms, bn)
    # part p sums terms [p * per, (p + 1) * per), as the kernel's blockIdx.z
    runs = [range(p * per, min(n_terms, (p + 1) * per))
            for p in range(parts)]
    assert sorted(q for r in runs for q in r) == list(range(n_terms))
    assert all(len(r) > 0 for r in runs) or n_terms == 0
    assert 1 <= parts <= tc.MAX_SPLIT
    choice = tc.gather_choice(torch.bfloat16, n_out, 96, cout, n_terms)
    assert (choice.parts, choice.per) == (parts, per)
    assert choice.scratch_numel(n_out, cout) <= tc.MAX_SPLIT * n_out * cout
    grid = -(-n_out // tc.ROW_TILE) * -(-cout // bn)
    if grid >= tc.SMS:
        assert parts == 1 and choice.scratch_numel(n_out, cout) == 0
    elif grid and n_terms > 1:
        # splits until the card is full or the terms or MAX_SPLIT run out
        assert parts > 1
        assert (grid * parts >= tc.SMS or parts == n_terms
                or -(-n_terms // per) == parts)


def test_split_at_the_model_levels():
    """The 512-row level at Cout 256 splits its 27 terms in 14 runs of 2;
    the 65,536-row level keeps one part."""
    assert tc.term_split(512, 256, 27, 128) == (14, 2)
    assert tc.term_split(65536, 96, 27, 96) == (1, 27)
    assert tc.term_split(1024, 256, 27, 128) == (9, 3)


@pytest.mark.parametrize("c,cout,bn", [(96, 96, 96), (32, 256, 128),
                                       (64, 64, 64), (128, 32, 32),
                                       (256, 128, 128), (96, 192, 96),
                                       (96, 384, 128), (96, 160, 32),
                                       (96, 20, 32), (27, 32, 32),
                                       (27, 96, 32), (96, 27, 32)])
def test_column_tile(c, cout, bn):
    """The least padding of Cout, the larger tile on a tie; 32 when a row
    is not whole 16-byte pieces (element-by-element staging)."""
    assert tc.column_tile(c, cout) == bn


def test_stem_and_its_padded_run_launch_alike():
    """The C = 27 stem and the same call with Cin zero-padded to 32 take
    the same tile and split, so the smoke's bit-for-bit identity holds."""
    for n_out in (512, 14848, 65536):
        assert (tc.gather_choice(torch.bfloat16, n_out, 27, 32, 27)
                == tc.gather_choice(torch.bfloat16, n_out, 32, 32, 27))


@pytest.mark.parametrize("c,cout,tiles", [(96, 96, (96, 96)),
                                          (256, 256, (64, 64)),
                                          (128, 32, (64, 32)),
                                          (384, 96, (96, 96)),
                                          (27, 32, (32, 32)),
                                          (256, 200, (64, 32))])
def test_dw_tiles(c, cout, tiles):
    assert tc.dw_tiles(c, cout) == tiles


@pytest.mark.parametrize("rows,c,cout,n_terms,chunks", [
    (65536, 96, 96, 27, 8), (65536, 32, 32, 27, 76), (65536, 32, 32, 8, 128),
    (14848, 96, 96, 8, 28), (3584, 128, 128, 27, 5), (512, 256, 256, 27, 1),
    (100, 27, 32, 27, 1), (0, 32, 32, 27, 0)])
def test_dw_chunk_rows(rows, c, cout, n_terms, chunks):
    """d_w's row chunks: whole 32-row steps, every row in one chunk, at
    most DW_MAX_CHUNKS (so the scratch is at most that many times d_w),
    no chunk longer than DW_MAX_CHUNK_ROWS unless a chunk is a single
    step, and more chunks where the grid has fewer warps."""
    per = tc.dw_chunk_rows(rows, c, cout, n_terms)
    assert per % 32 == 0 and per >= 32
    assert per == tc.dw_chunk_rows(rows, c, cout, n_terms)
    n = -(-rows // per)
    assert n == chunks
    assert n <= tc.DW_MAX_CHUNKS and (n - 1) * per < max(rows, 1)
    assert per <= max(tc.DW_MAX_CHUNK_ROWS, 32)


def test_float32_stays_on_cuda_cores():
    """The input type alone picks the core: f32 never reaches the tensor
    cores, whatever the shape, and there is no other switch."""
    for n_out, cout, n_terms in SHAPES:
        assert tc.gather_choice(torch.float32, n_out, 96, cout,
                                n_terms).core == "cuda"
        assert tc.gather_choice(torch.bfloat16, n_out, 96, cout,
                                n_terms).core == "tensor"


def test_cpu_tensors_count_no_launch():
    """On the CPU the wrappers take the plain versions: no launch is
    counted."""
    K.reset_launch_counts()
    feats = torch.ones(64, 8, dtype=torch.bfloat16)
    starts = torch.zeros(1, 1, dtype=torch.int32)
    idx = torch.zeros(1, 1, 1, 64, dtype=torch.int32)
    w = torch.ones(1, 1, 8, 8, dtype=torch.bfloat16)
    out = K.window_gather_matmul(feats, starts, idx, w)
    assert torch.equal(out, torch.full((64, 8), 8.0, dtype=torch.bfloat16))
    K.window_bwd(out, feats, starts, idx, w)
    counts = K.launch_counts()
    assert counts["window_gather_matmul"] == counts["window_bwd"] == 0


def test_k4_stem_choice():
    """K4's one call per training step (conv0a: 65,536 rows, C = 27,
    Cout = 32, 27 terms): bf16 on the tensor cores in 32 x 32 tiles with
    element staging, 76 row chunks of 864 rows; float32 on the CUDA cores
    in 16 chunks of 4,096."""
    bf = tc.dw_choice(torch.bfloat16, 65536, 27, 32, 27)
    assert (bf.core, bf.tiles, bf.chunk_rows) == ("tensor", (32, 32), 864)
    assert bf.chunks(65536) == 76 and not tc.vector_ok(27, 32)
    assert bf.describe(65536)["row_chunks"] == 76
    f32 = tc.dw_choice(torch.float32, 65536, 27, 32, 27)
    assert (f32.core, f32.chunk_rows, f32.chunks(65536)) == ("cuda", 4096,
                                                             16)
    # K3's d_w half takes the same rule
    assert tc.dw_choice(torch.bfloat16, 65536, 32, 32, 27).chunk_rows == 864


class _FakeLaunch:
    """Stands in for the C entry point: records its arguments."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def fake_k5(monkeypatch):
    fake = _FakeLaunch()
    monkeypatch.setattr(gather_matmul_bs.build, "function",
                        lambda *a: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return fake


def _k5_inputs(n_out, c, cout, block, dtype, g=9, m=3, tile=32):
    nt = -(-n_out // tile)
    return (torch.zeros(n_out + 5, c, dtype=dtype),
            torch.zeros(g, nt, dtype=torch.int32),
            torch.full((g, nt, m, tile), -1, dtype=torch.int32),
            torch.zeros(g, m, c, cout, dtype=dtype),
            torch.ones(g, m, -(-c // block), -(-cout // block),
                       dtype=torch.uint8))


@pytest.mark.parametrize("n_out,c,cout,block", [
    (512, 256, 256, 32), (512, 128, 128, 128), (3584, 64, 64, 32),
    (65536, 96, 96, 32), (2048, 27, 32, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_takes_k2s_choice(fake_k5, n_out, c, cout, block, dtype):
    """K5's launch carries exactly K2's core, column tile and term split
    (``tc.gather_choice``), with f32 scratch for the split's partials, so
    its sums are added as K2's are."""
    args = _k5_inputs(n_out, c, cout, block, dtype)
    K.reset_launch_counts()
    out = gather_matmul_bs._launch(*args, block, masked=True)
    assert out.shape == (n_out, cout) and out.dtype == dtype
    assert K.launch_counts()["window_gather_matmul_bs"] == 1
    choice = tc.gather_choice(dtype, n_out, c, cout, 27)
    bf16, bn, parts, per, part = fake_k5.args[16:21]
    assert bf16 == int(dtype == torch.bfloat16) == int(choice.core
                                                       == "tensor")
    assert (bn, parts, per) == (choice.column_tile, choice.parts, choice.per)
    assert (part is None) == (parts == 1)
    K.reset_launch_counts()


def test_k5_refuses_what_the_tensor_core_cannot_take(fake_k5):
    """bf16: rows that do not start on a 16-byte boundary, and more than
    ``MAX_C`` channels (one mask bit per 32-channel chunk)."""
    feats, starts, idx, w, live = _k5_inputs(512, 64, 64, 32,
                                             torch.bfloat16)
    buf = torch.zeros(feats.numel() + 8, dtype=torch.bfloat16)
    for off in range(8):  # one of them is misaligned
        f = buf[off:off + feats.numel()].view(feats.shape)
        if f.data_ptr() % tc.ALIGN:
            break
    with pytest.raises(ValueError, match="boundary"):
        gather_matmul_bs._launch(f, starts, idx, w, live, 32, True)
    big = _k5_inputs(64, gather_matmul_bs.MAX_C + 8, 8, 128, torch.bfloat16,
                     g=1, m=1)
    with pytest.raises(ValueError, match="MAX_C|> 1024"):
        gather_matmul_bs._launch(*big, 128, True)
    assert fake_k5.args is None


def _brute_share(live, block, c, cout, bn):
    live = live.numpy()
    total = hit = 0
    for q in live.reshape(-1, *live.shape[-2:]):
        for k0 in range(0, c, 32):
            for col0 in range(0, cout, bn):
                total += 1
                hit += any(q[bi, bo]
                           for bi in range(k0 // block,
                                           (min(k0 + 32, c) - 1) // block + 1)
                           for bo in range(col0 // block,
                                           (min(col0 + bn, cout) - 1)
                                           // block + 1))
    return hit / total


@pytest.mark.parametrize("block,c,cout,dead", [
    (4, 27, 20, 0.5), (16, 40, 72, 0.5), (32, 256, 256, 0.5),
    (32, 96, 96, 0.75), (128, 256, 128, 0.5), (128, 200, 264, 0.3)])
def test_live_step_share_counts_the_steps(block, c, cout, dead):
    """The live-step share of a spec under K2's column tile equals a
    brute-force count of the (term, 32-channel chunk, column tile) steps
    with a live block under them."""
    rng = np.random.default_rng(block + c)
    live = torch.as_tensor(
        rng.random((3, 3, -(-c // block), -(-cout // block))) >= dead,
        dtype=torch.uint8)
    live[0, 1] = 0
    bn = tc.column_tile(c, cout)
    got = gather_matmul_bs.live_step_share(live, block, c, cout, bn)
    assert got == pytest.approx(_brute_share(live, block, c, cout, bn),
                                abs=1e-12)
    full = torch.ones_like(live)
    assert gather_matmul_bs.live_step_share(full, block, c, cout, bn) == 1.0


# K6 on the row path of eval_64k: (N_out, C = Cout, K) -> (column tile,
# parts, steps per part); 2 (ZAXIS) or 4 (strided offsets) terms of
# ceil(C / 32) chunks each; and a ragged Cout
ROW_CHOICES = [
    ((14848, 32, 32, 2), (32, 1, 2)), ((14848, 32, 32, 4), (32, 1, 4)),
    ((3584, 32, 32, 2), (32, 2, 1)), ((3584, 32, 32, 4), (32, 4, 1)),
    ((1024, 64, 64, 2), (64, 4, 1)), ((1024, 64, 64, 4), (64, 8, 1)),
    ((512, 128, 128, 2), (128, 8, 1)), ((512, 128, 128, 4), (128, 16, 1)),
    ((512, 40, 72, 3), (96, 6, 1)), ((333, 40, 72, 27), (96, 14, 4)),
    # ResNet14's four k3/s2 convs (27 terms) at the level sizes of 16
    # shells of 10,000 voxels
    ((16384, 64, 64, 27), (64, 1, 54)), ((4096, 64, 128, 27), (128, 5, 11)),
    ((1024, 128, 256, 27), (128, 9, 12)),
    ((256, 256, 512, 27), (128, 16, 14)),
]


@pytest.mark.parametrize("shape,want", ROW_CHOICES)
def test_k6_row_choice_covers_every_step_once(shape, want):
    """bf16 K6 runs on the tensor cores; where its grid would leave SMs
    idle, its (term, 32-channel chunk) steps go in contiguous runs to
    several parts (at most ``MAX_SPLIT``, none empty), and the runs cover
    every step once."""
    n_out, c, cout, k = shape
    ch = tc.row_choice(torch.bfloat16, n_out, c, cout, k)
    assert (ch.core, ch.vec) == ("tensor", True)
    assert (ch.column_tile, ch.parts, ch.per) == want
    steps = k * -(-c // tc.CHUNK)
    runs = [range(p * ch.per, min(steps, (p + 1) * ch.per))
            for p in range(ch.parts)]
    assert all(len(r) for r in runs) and ch.parts <= tc.MAX_SPLIT
    assert sorted(s for r in runs for s in r) == list(range(steps))
    blocks = -(-n_out // tc.ROW_TILE) * -(-cout // ch.column_tile)
    assert ch.parts == 1 or blocks < tc.SMS
    assert tc.row_choice(torch.float32, n_out, c, cout, k).core == "cuda"
    # off a 16-byte boundary: element staging in the 32-column tile
    mis = tc.row_choice(torch.bfloat16, n_out, c, cout, k, aligned=False)
    assert (mis.vec, mis.column_tile) == (False, 32)


@pytest.fixture
def fake_k6(monkeypatch):
    fake = _FakeLaunch()
    monkeypatch.setattr(row_gather.build, "function", lambda *a: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return fake


@pytest.mark.parametrize("shape,_", ROW_CHOICES[:8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_launch_carries_its_choice(fake_k6, shape, _, dtype):
    """K6's launch carries ``row_choice``'s core, tile, staging and split,
    with f32 scratch for the split's partials and an f32 output."""
    n_out, c, cout, k = shape
    x = torch.zeros(n_out + 1, c, dtype=dtype)
    km = torch.zeros(k, n_out, dtype=torch.int32)
    w = torch.zeros(k, c, cout, dtype=dtype)
    K.reset_launch_counts()
    out = row_gather._launch(x, km, w)
    assert out.shape == (n_out, cout) and out.dtype == torch.float32
    assert K.launch_counts()["row_gather_matmul"] == 1
    ch = tc.row_choice(dtype, n_out, c, cout, k, tc.aligned(x, w))
    bf16, bn, vec, parts, per, part = fake_k6.args[9:15]
    assert bf16 == int(ch.core == "tensor") == int(dtype == torch.bfloat16)
    assert (bn, vec, parts, per) == (ch.column_tile, int(ch.vec), ch.parts,
                                     ch.per)
    assert (part is None) == (parts == 1)
    K.reset_launch_counts()


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_sgd_matches_reference_sgd(nesterov, weight_decay):
    """Five steps of momentum 0.9 SGD, with and without Nesterov and
    weight decay: the port's update equals the JAX package's (optax)."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(5)]
    tx = JO.sgd(0.1, weight_decay=weight_decay, momentum=0.9,
                nesterov=nesterov)
    p_ref = jnp.asarray(p0)
    state = tx.init(p_ref)
    p = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = TO.sgd([p], 0.1, weight_decay=weight_decay, momentum=0.9,
                 nesterov=nesterov)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        p.grad = torch.as_tensor(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_ref),
                                   rtol=1e-6, atol=1e-6)


def test_sgd_refuses_dampening_with_momentum():
    """The reference's SGD has no dampening: the port refuses it where it
    would change the update, and takes it where torch ignores it too."""
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="dampening"):
        TO.sgd([p], 0.1, momentum=0.9, dampening=0.1)
    TO.sgd([p], 0.1, momentum=0.0, dampening=0.1)
    TO.sgd([p], 0.1, momentum=0.9)
