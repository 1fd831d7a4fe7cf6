"""The window plan's starts on the CPU: ``window_starts_plain`` against the
JAX package, the by-value deltas of K1 and the pass, and no host tensors
on a warm forward.

``window_starts_plain`` (the plain version of the pass the card runs
before K1) must give the JAX package's ``build_plan_direct`` starts and
``n_escaped`` bit for bit: on a table of a multiple of 256 rows (the
hierarchical lower bound), on all-valid tables of 1,000 and 200 rows (the
fixed-step lower bound with its overshoot to N + 1), with masked tail
tiles, on a cross plan at tile 128 and blocks 6, and on a transposed
offset set. The delta words the wrappers pack into the kernels' parameter
are checked through a stand-in for the C entry points. A second forward of
a small pruned model (row path, padded subsets, escape lists, transpose
convs) converts no Python list or array to a tensor in
``ops/window_conv.py``, ``sparse/kernels.py`` or ``models/mink/layers.py``
and makes no new constant at all.
"""

import contextlib
import functools
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu.ops import window_conv as jwc  # noqa: E402
from nerf_downstream_tpu_torch.ops import consts  # noqa: E402
from nerf_downstream_tpu_torch.ops import kernels as K  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as twc  # noqa: E402
from nerf_downstream_tpu_torch.ops.kernels import match  # noqa: E402
from tests.test_torch_port_cuda import (  # noqa: E402
    STARTS_CASES,
    starts_args,
    starts_case,
)


@pytest.fixture(autouse=True)
def _xla_match(monkeypatch):
    # the reference's starts do not depend on how it matches; its XLA
    # match is the cheaper one on the CPU
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")


@pytest.mark.parametrize("case", sorted(STARTS_CASES))
def test_window_starts_plain_matches_reference(case):
    table, query, offs, kw = starts_case(case)
    extra = {} if query is None else dict(
        out_coords=jnp.asarray(query[0].numpy()),
        out_mask=jnp.asarray(query[1].numpy()))
    ref = jax.jit(functools.partial(jwc.build_plan_direct, offsets=offs,
                                    **kw))(jnp.asarray(table[0].numpy()),
                                           jnp.asarray(table[1].numpy()),
                                           **extra)
    args = starts_args(table, query, offs, **kw)
    starts, emax, n_escaped = K.window_starts(*args)
    assert starts.dtype == emax.dtype == n_escaped.dtype == torch.int32
    np.testing.assert_array_equal(starts.numpy(), np.asarray(ref.starts))
    assert int(n_escaped) == int(ref.n_escaped)
    # the plan the port builds carries the same starts
    plan = twc.build_plan_direct(*table, offs, **kw, **(
        {} if query is None else dict(out_coords=query[0],
                                      out_mask=query[1])))
    assert torch.equal(plan.starts, starts)
    if case.startswith("fixed"):  # all rows valid: the search overshoots
        assert int(emax.max()) == table[0].shape[0] + 1


@pytest.mark.parametrize("case", sorted(STARTS_CASES))
def test_starts_split_by_groups_equal_one_launch(case, monkeypatch):
    """Where one launch of the pass would not fit its shared memory, the
    groups go to launches of their own: with the budget shrunk to one
    group (and to two) per launch, the starts, emax and escape count
    equal one launch's, here through the plain version."""
    table, query, offs, kw = starts_case(case)
    args = starts_args(table, query, offs, **kw)
    whole = K.window_starts_plain(*args)
    deltas, nt = args[6], args[2].shape[0] // args[7]
    for per in (1, 2):
        monkeypatch.setattr(match, "_MAX_SMEM", 4 * len(deltas[0]) * nt * per)
        calls = []

        def launch(*a):
            calls.append(len(a[6]))
            return K.window_starts_plain(*a)

        got = match.starts_by_groups(launch, *args)
        assert calls == [min(per, len(deltas) - g)
                         for g in range(0, len(deltas), per)]
        for a, b in zip(got, whole):
            assert torch.equal(a, b)


class _FakeLaunch:
    """Stands in for a C entry point: records its arguments."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    fake = _FakeLaunch()
    monkeypatch.setattr(match.build, "function", lambda *a: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return fake


def _words(deltas):
    return [int(v) & 0xFFFFFFFF for row in deltas for d in row for v in d]


@pytest.mark.parametrize("case", ["hier_512", "transposed"])
def test_launches_pack_the_deltas_by_value(fake_launch, case):
    """K1 and the pass get each (group, member)'s delta words in the
    kernels' parameter, term g * M + m, unused terms zero, with the plan's
    shapes, K1's rows per block and the coverage."""
    table, query, offs, kw = starts_case(case)
    args = starts_args(table, query, offs, **kw)
    hi, lo, o_hi, o_lo, nvi, nvo, deltas, tile, window, blocks = args
    perm, want = twc.plan_layout(offs, kw.get("transpose", False))
    assert deltas == want and len(perm) == len(offs)
    g_count, m = len(deltas), len(deltas[0])
    n = o_hi.shape[0]
    nt = n // tile

    K.reset_launch_counts()
    starts, emax, n_esc = match._launch_starts(*args)
    a = fake_launch.args
    assert a[2] == hi.shape[0] and a[8:14] == (g_count, m, nt, tile, window,
                                               blocks * window)
    packed = a[7]
    assert isinstance(packed, match.Deltas)
    flat = list(packed.hi[:]) + list(packed.lo[:])
    got = [w for q in range(g_count * m) for w in (flat[q],
                                                   flat[match.MAX_TERMS + q])]
    assert got == _words(deltas)
    assert not any(flat[g_count * m:match.MAX_TERMS])
    assert starts.shape == emax.shape == (g_count, nt) and n_esc.dim() == 0

    mask = (table if query is None else query)[1]
    match._launch_match(hi, lo, o_hi, o_lo, mask, deltas, starts, tile,
                        window, blocks)
    a = fake_launch.args
    assert a[8:14] == (g_count, nt, m, tile,
                       match.rows_per_block(nt, tile, g_count),
                       blocks * window)
    assert bytes(a[6]) == bytes(packed)
    assert K.launch_counts()["window_starts"] == 1
    assert K.launch_counts()["window_match"] == 1
    K.reset_launch_counts()


def test_pack_deltas_words_and_limit():
    packed = match.pack_deltas((((-1, 5), (2, -65536)),))
    assert (packed.hi[0], packed.lo[0]) == (0xFFFFFFFF, 5)
    assert (packed.hi[1], packed.lo[1]) == (2, 0xFFFF0000)
    with pytest.raises(ValueError, match="at most"):
        match.pack_deltas((((0, 0),) * (match.MAX_TERMS + 1),))


@pytest.mark.parametrize("nt,tile,groups,rows", [
    (256, 256, 9, 256), (116, 128, 4, 128), (2, 256, 9, 32),
    (14, 256, 9, 64), (4, 128, 4, 32), (8, 16, 9, 16)])
def test_k1_rows_per_block(nt, tile, groups, rows):
    """Whole tiles where the grid fills the SMs, split tiles (at least 32
    rows) where it would not."""
    assert match.rows_per_block(nt, tile, groups) == rows


def test_window_starts_refuses_other_devices():
    k = torch.empty(4, dtype=torch.int32, device="meta")
    s = torch.empty((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.window_starts(k, k, k, k, s, s, ((0, 0),), 4, 4)


_PORT = os.path.dirname(os.path.dirname(os.path.abspath(twc.__file__)))
_WATCHED = tuple(os.path.join(_PORT, *p) for p in (
    ("ops", "window_conv.py"), ("sparse", "kernels.py"),
    ("models", "mink", "layers.py")))


def test_warm_forward_makes_no_host_tensors(monkeypatch):
    """The second forward of a small Res16UNet14 pruned to offset subsets
    (padded and symmetric subsets with escape lists, down convs on the row
    path, transpose convs) calls ``torch.as_tensor``/``torch.tensor`` with
    a device from none of the three files, and adds no constant."""
    from nerf_downstream_tpu_torch import convert, eval3d
    from nerf_downstream_tpu_torch.sparse.types import PointField
    from tests.test_torch_port_sparse_model import (
        TIGHT,
        model_batch,
        prune_model_tree,
    )

    batch = model_batch()
    dense = eval3d.get_model("Res16UNet14", in_channel=27, out_channel=20,
                             planes=(8,) * 8)
    variables = convert.init_flax_variables(dense, 5)
    variables["params"] = prune_model_tree(variables["params"], "offsets",
                                           np.random.default_rng(1))
    vmap, _ = eval3d.derive_maps(variables["params"], [1] * 9, "strided",
                                 granularity=4)
    monkeypatch.setitem(eval3d.serve.PRESETS, "tiny", dict(
        scenes=2, capacity=1024, grid_extent=64, assume_unique=True,
        ctx=TIGHT))
    model = eval3d.build_evaluator(
        "tiny", variables, sparse_mode=[1] * 9, valid_offsets_map=vmap,
        device="cpu", compute_dtype=torch.float32, model="Res16UNet14",
        planes=(8,) * 8)
    field = PointField(coords=torch.as_tensor(batch["coordinates"]),
                       feats=torch.as_tensor(batch["features"]),
                       mask=torch.as_tensor(batch["mask"]))
    calls = []

    def watch(fn):
        def wrapped(*args, **kwargs):
            where = sys._getframe(1).f_code.co_filename
            if "device" in kwargs and where in _WATCHED:
                calls.append(where)
            return fn(*args, **kwargs)
        return wrapped

    with torch.inference_mode():
        first = model(field)
        made = len(consts._CACHE)
        monkeypatch.setattr(torch, "as_tensor", watch(torch.as_tensor))
        monkeypatch.setattr(torch, "tensor", watch(torch.tensor))
        second = model(field)
    assert eval3d.route_counts(model) == {"row": 4, "windowed": 22}
    assert calls == []
    assert len(consts._CACHE) == made
    assert torch.equal(torch.isnan(first), torch.isnan(second))


def test_constants_made_in_inference_mode_serve_training():
    """A constant first made during an inference forward is a normal
    tensor: a later training forward may index with it under autograd."""
    perm = consts.const((2, 0, 1, 3), torch.int64, "cpu")
    with torch.inference_mode():
        fresh = consts.const((3, 1, 2, 0, 4), torch.int64, "cpu")
    assert not fresh.is_inference() and not perm.is_inference()
    w = torch.ones(5, 2, requires_grad=True)
    (w[fresh] * 2).sum().backward()
    assert torch.equal(w.grad, torch.full((5, 2), 2.0))
