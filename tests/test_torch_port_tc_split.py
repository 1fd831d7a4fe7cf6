"""The launch choices of the bf16 tensor-core path of K2 and K3
(``nerf_downstream_tpu_torch/ops/kernels/tc.py``), on the CPU: the column
tile of the gather-matmul core, the split of the G x M terms over blocks
at coarse levels, and the d_w tiles. The kernels themselves run on the
card only (``tests/test_torch_port_cuda.py``)."""

import pytest

torch = pytest.importorskip("torch")

from nerf_downstream_tpu_torch.ops import kernels as K  # noqa: E402
from nerf_downstream_tpu_torch.ops.kernels import tc  # noqa: E402

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
