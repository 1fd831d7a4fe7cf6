"""The port's CPU sums repeat bit for bit at eight threads.

At more than one thread PyTorch's CPU ``index_put(..., accumulate=True)``
(and so the backward of an advanced-index gather ``x[idx]``) adds floats
with parallel atomics, in whatever order they land. The port routes
every accumulating scatter through ``ops/scatter.py`` (``index_add_`` on
the CPU, the sorting ``index_put`` on the card) and every gather whose
backward accumulates through ``gather_rows`` (``index_select`` on the
CPU). Each case runs 20 times at ``torch.set_num_threads(8)`` and must
give one result:

- the helpers: 200,000 rows of 8 values into 997 rows, and a gather's
  backward over the same indices;
- a windowed conv with escape entries (``_esc_scatter``), forward and
  backward;
- instance norm's statistics (its segment sums);
- a window pool's backward;
- ``splat``;
- PAConv's assign-score backward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nerf_downstream_tpu_torch.ops import interpolate as TI  # noqa: E402
from nerf_downstream_tpu_torch.ops import paconv as TP  # noqa: E402
from nerf_downstream_tpu_torch.ops import pool as TPool  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as TW  # noqa: E402
from nerf_downstream_tpu_torch.ops.norm import instance_norm_stats  # noqa: E402
from nerf_downstream_tpu_torch.ops.scatter import (  # noqa: E402
    add_rows,
    gather_rows,
)
from nerf_downstream_tpu_torch.sparse import kernels as tk  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import PointField  # noqa: E402

REPEATS = 20
ROWS, OUT_ROWS, WIDTH = 200_000, 997, 8


@pytest.fixture(autouse=True)
def _eight_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(n)


def distinct(fn) -> int:
    """How many different results ``fn`` gives in REPEATS calls (each a
    tensor or a tuple of tensors, compared byte for byte)."""
    seen = set()
    for _ in range(REPEATS):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        seen.add(b"".join(t.detach().contiguous().numpy().tobytes()
                          for t in out))
    return len(seen)


def scatter_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, OUT_ROWS, (ROWS,), generator=g)
    vals = torch.randn(ROWS, WIDTH, generator=g)
    return idx, vals


def test_add_rows_repeats():
    idx, vals = scatter_inputs()
    assert distinct(lambda: add_rows(torch.zeros(OUT_ROWS, WIDTH), idx,
                                     vals)) == 1


def test_gather_backward_repeats():
    idx, vals = scatter_inputs(1)
    x = torch.randn(OUT_ROWS, WIDTH, requires_grad=True)

    def grad():
        x.grad = None
        (gather_rows(x, idx) * vals).sum().backward()
        return x.grad

    assert distinct(grad) == 1


def escaping_level(n_rows=24_576, seed=2):
    """A random level of one scene (sorted unique coordinates) and a
    same-set window plan whose window is short enough that many entries
    take the escape list."""
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, 40, size=(n_rows, 3)), axis=0)
    n = len(pts)
    coords = np.zeros((n_rows, 4), np.int32)
    coords[:n, 1:] = pts
    mask = np.arange(n_rows) < n
    sv, _ = tk.field_to_sparse(PointField(
        coords=torch.as_tensor(coords, dtype=torch.float32),
        feats=torch.zeros(n_rows, 1), mask=torch.as_tensor(mask)),
        assume_unique=True)
    offs = tk.kernel_offsets(3, 1)
    kw = dict(tile=128, window=96, blocks=2, escape_cap=60_000,
              escape_tiles=4096)
    plan = TW.build_plan_direct(sv.coords, sv.mask, offs, **kw)
    inv = TW.build_plan_direct(sv.coords, sv.mask, offs, transpose=True,
                               **kw)
    return sv, plan, inv


def test_windowed_conv_with_escapes_repeats():
    sv, plan, inv = escaping_level()
    assert int(plan.n_escaped) == 0
    n_esc = int((plan.esc_k >= 0).sum())
    assert n_esc > 10_000  # the escape side path carries real work
    rng = np.random.default_rng(3)
    c = 16
    feats = torch.tensor(rng.normal(size=(sv.capacity, c)).astype(np.float32),
                         requires_grad=True)
    w = torch.tensor(rng.normal(size=(27, c, c)).astype(np.float32),
                     requires_grad=True)
    g = torch.as_tensor(rng.normal(size=(sv.capacity, c)).astype(np.float32))

    def step():
        feats.grad = w.grad = None
        out = TW.window_conv_apply(feats, plan, inv, w)
        (out * g).sum().backward()
        return out, feats.grad, w.grad

    assert distinct(step) == 1


def test_instance_norm_stats_repeat():
    _, vals = scatter_inputs(4)
    ids = torch.as_tensor(np.random.default_rng(5).integers(0, 4, ROWS))
    assert distinct(lambda: instance_norm_stats(vals, ids, 3)) == 1


def test_window_pool_backward_repeats():
    rng = np.random.default_rng(6)
    n_in, n_out = 50_000, 8_000
    km = torch.as_tensor(rng.integers(0, n_in + 1, size=(8, n_out)),
                         dtype=torch.int32)
    x = torch.tensor(rng.normal(size=(n_in, 16)).astype(np.float32),
                     requires_grad=True)

    def grad():
        x.grad = None
        TPool.window_pool(x, km, "avg").square().sum().backward()
        return x.grad

    assert distinct(grad) == 1


def test_splat_repeats():
    rng = np.random.default_rng(7)
    n = 60_000
    coords = np.zeros((n, 4), np.float32)
    coords[:, 1:] = rng.uniform(0, 12, size=(n, 3))
    vox = np.unique(np.floor(coords[:, 1:]).astype(np.int32), axis=0)
    vox = np.unique(np.concatenate([vox, vox + 1]), axis=0)
    out_coords = np.zeros((len(vox), 4), np.int32)
    out_coords[:, 1:] = vox
    field = PointField(coords=torch.as_tensor(coords),
                       feats=torch.as_tensor(rng.normal(size=(n, 8)).astype(
                           np.float32)),
                       mask=torch.ones(n, dtype=torch.bool))
    oc = torch.as_tensor(out_coords)
    om = torch.ones(len(vox), dtype=torch.bool)
    assert distinct(lambda: TI.splat(field, oc, om, 1)) == 1


def test_assign_score_backward_repeats():
    rng = np.random.default_rng(8)
    b, n, k, m, o = 2, 4096, 8, 8, 16
    scores = torch.tensor(rng.normal(size=(b, n, k, m)).astype(np.float32),
                          requires_grad=True)
    points = torch.tensor(rng.normal(size=(b, n, m, o)).astype(np.float32),
                          requires_grad=True)
    centers = torch.tensor(rng.normal(size=(b, n, m, o)).astype(np.float32),
                           requires_grad=True)
    knn = torch.as_tensor(rng.integers(0, 64, size=(b, n, k)))

    def grads():
        for t in (scores, points, centers):
            t.grad = None
        TP.assign_score_withk(scores, points, centers, knn).sum().backward()
        return scores.grad, points.grad, centers.grad

    assert distinct(grads) == 1
