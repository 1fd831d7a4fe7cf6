"""Checkpoints of the PyTorch port against the JAX package's format, and
the ``eval3d`` entry point on the CPU.

A checkpoint written by the reference's ``save_checkpoint`` (flax msgpack:
parameters, batch statistics, an optax state, the step and metadata) must
be read by the port bit-exact, leaf by leaf; one written by the port must
be read by ``flax.serialization.msgpack_restore`` bit-exact and be byte
for byte what ``msgpack_serialize`` writes for the same tree. The reader
refuses what it does not know. ``eval3d.main`` with ``--device cpu`` at a
tiny preset writes ``{tag}.json`` from a pruned port checkpoint (masks
folded), skips the tag again without ``--replace``, and refuses the
options whose modules are not ported.
"""

import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization as fser  # noqa: E402
import jax  # noqa: E402
import optax  # noqa: E402

from nerf_downstream_tpu.train import checkpoints as jck  # noqa: E402
from nerf_downstream_tpu_torch import convert, eval3d, serve  # noqa: E402
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from nerf_downstream_tpu_torch.utils import prune as tprune  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "conv0a_conv": {"kernel": rng.normal(size=(27, 5, 4))
                        .astype(np.float32)},
        "block1_0": {"conv1": {"kernel": rng.normal(size=(27, 4, 4))
                               .astype(np.float32)}},
        "final": {"kernel": rng.normal(size=(1, 4, 3)).astype(np.float32),
                  "bias": np.zeros(3, np.float32)},
    }


def leaves_equal(a, b):
    fa, fb = tprune.flatten(a), tprune.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_reads_reference_checkpoint(tmp_path):
    params = small_tree(0)
    stats = {"MaskedBatchNorm_0": {"mean": np.arange(4, dtype=np.float32),
                                   "var": np.ones(4, np.float32)}}
    opt = optax.sgd(0.1, momentum=0.9).init(params)
    state = types.SimpleNamespace(params=params, batch_stats=stats,
                                  opt_state=opt, step=np.int32(17))
    path = str(tmp_path / "ref.ckpt")
    jck.save_checkpoint(path, state, meta={"run": "x", "lr": 0.5,
                                           "sizes": [1, 2, 300],
                                           "flag": True, "none": None})
    got = tck.load_checkpoint(path)
    want = jck.load_checkpoint(path)
    leaves_equal(got["params"], jax.device_get(want["params"]))
    leaves_equal(got["batch_stats"], jax.device_get(want["batch_stats"]))
    leaves_equal(got["opt_state"], jax.device_get(want["opt_state"]))
    assert got["global_step"] == want["global_step"] == 17
    raw = tck.load_checkpoint_raw(path)
    assert raw["meta"] == {"run": "x", "lr": 0.5, "sizes": [1, 2, 300],
                           "flag": True, "none": None}
    assert got["pruning_masks"] == {}


def test_reference_reads_port_checkpoint(tmp_path):
    params, stats = small_tree(1), {"bn": {"var": np.ones(4, np.float32)}}
    masks = {"block1_0/conv1/kernel": np.random.default_rng(2).random(
        (27, 4, 4)) > 0.5}
    path = str(tmp_path / "port.ckpt")
    tck.save_checkpoint(path, params, stats, global_step=3,
                        meta={"seed": 0, "note": "é" * 40},
                        pruning_masks=masks)
    with open(path, "rb") as f:
        data = f.read()
    restored = fser.msgpack_restore(data)
    leaves_equal(restored["state_dict"]["params"], params)
    leaves_equal(restored["state_dict"]["batch_stats"], stats)
    leaves_equal(restored["pruning_masks"], masks)
    assert restored["global_step"] == 3
    assert restored["meta"] == {"seed": 0, "note": "é" * 40}
    assert fser.msgpack_serialize(restored) == data
    loaded = jck.load_checkpoint(path)
    leaves_equal(jax.device_get(loaded["params"]), params)


def test_reader_refuses_unknown_content():
    with pytest.raises(ValueError, match="extension type"):
        tck.unpackb(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="chunked"):
        tck.unpackb(tck.packb({"__msgpack_chunked_array__": True}))
    with pytest.raises(ValueError, match="trailing"):
        tck.unpackb(b"\x01\x02")
    with pytest.raises(TypeError):
        tck.packb({"x": object()})
    assert tck.unpackb(tck.packb([np.float32(1.5), -40, 2 ** 40])) == [
        1.5, -40, 2 ** 40]


TINY = dict(scenes=2, capacity=1024, grid_extent=128, assume_unique=True,
            ctx=dict(level_caps=(1024, 512, 256, 128, 64), window_tile=64,
                     window_size=256, window_blocks=4, window_expand_factor=3,
                     window_escape_tiles=(144, 72, 36, 2, 2)))


def test_eval3d_cli_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(serve.PRESETS, "tiny", TINY)
    monkeypatch.setattr(serve, "VOXELS_PER_SCENE", 400)
    model_kw = dict(planes=(8,) * 8)
    model = eval3d.get_model("Res16UNet14", in_channel=27, out_channel=20,
                             **model_kw)
    variables = convert.init_flax_variables(model, 0)
    _, masks = tprune.magnitude_prune(variables["params"], 0.5)
    # one conv also loses whole offsets, so mode 1 has a map entry
    keep = np.zeros((27, 1, 1), bool)
    keep[[4, 13, 22]] = True
    masks["block2_0/conv1/kernel"] = masks["block2_0/conv1/kernel"] & keep
    ckpt = str(tmp_path / "run" / "last.ckpt")
    tck.save_checkpoint(ckpt, variables["params"], variables["batch_stats"],
                        pruning_masks=masks)
    argv = ["--preset", "tiny", "--model", "Res16UNet14", "--device", "cpu",
            "--load_path", ckpt, "--batches", "1", "--sparsify",
            "--sparse_mode", "1,1,1,1,1,1,1,1,1", "--layout", "strided"]
    out = eval3d.main(argv, **model_kw)
    printed = capsys.readouterr().out
    assert "folded pruning masks: " in printed
    counts = tprune.count_parameters_tree(
        tprune.fold_pruning_masks(variables["params"], masks)[0])
    net = counts["total"] - counts["pruned"]
    assert f"num_params, total={counts['total']}, net={net}, " in printed
    assert net < counts["total"] * 0.55
    path = tmp_path / "run" / "run-cpu-True.json"
    results = json.loads(path.read_text())
    assert results == [out["results"]]
    assert set(out["results"]) == {"val/mIoU", "val/mAcc", "val/OA",
                                   "val/loss", "val/iter_time"}
    assert all(np.isfinite(v) for v in out["results"].values())
    assert out["routes"] == {"windowed": 26}
    mtime = os.path.getmtime(path)
    assert eval3d.main(argv, **model_kw) is None
    assert "skip existing experiment" in capsys.readouterr().out
    assert os.path.getmtime(path) == mtime
    assert eval3d.main(argv + ["--replace"], **model_kw) is not None
    # the reference's flags that need a dataset are co3d_3d.eval's alone
    for flag in ("--convert_powernorm", "--visualize"):
        with pytest.raises(SystemExit):
            eval3d.main(argv + ["--replace", flag], **model_kw)
    with pytest.raises(AssertionError, match="length 9"):
        eval3d.main(["--sparsify", "--sparse_mode", "1,1"])
    with pytest.raises(AssertionError, match="positive"):
        eval3d.main(["--sparsify", "--sparse_mode", "0,1,1,1,1,1,1,1,1"])


def test_eval3d_needs_a_gpu_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval3d.main(["--save_path", str(tmp_path), "--batches", "1"])
