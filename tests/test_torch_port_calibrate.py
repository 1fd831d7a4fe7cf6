"""The port's auto-calibration against the JAX package's, and the
classification CLI that needs it, on the CPU.

- ``calibrate`` on the same collated batches gives knobs integer-equal
  to the reference's (its ``build_plan_direct`` jitted here: integer
  arithmetic, the same results, a fifth of the eager dispatch time), and
  the Williams-design scene orders are the reference's.
- ``needs_calibration`` says what the reference's ``maybe_auto_calibrate``
  dry run says on the shipped configs and on variations of them.
- The reference's own CLI test (``tests/test_cli_3d.py::
  test_train_cli_co3d_classification``) NaN-poisons its validation pass.
  On its tree and seed, the knobs the reference calibrates from two train
  batches leave the stride-1 plan no escape list (cap 0); the first
  validation batch then flags a window escape at that plan, in both
  packages (guard parity), and so does the third train batch. The port's
  calibration also measures the validation batches: their escape
  candidates give the stride-1 level an escape list, which absorbs both,
  and the port's CLI runs that test's command with a finite validation
  loss; with the reference's knobs bound it stops on the NaN as the
  reference does.
- The CLI on ``co3d_cls`` + ``co3d_aug2`` + ``feature_sh`` + ``resnet14``
  at planes 8 calibrates, trains, validates and writes its checkpoints
  and ``val/acc1``.
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.models import get_model as jget_model  # noqa: E402
from nerf_downstream_tpu.ops import window_conv as JW  # noqa: E402
from nerf_downstream_tpu.train.modules import (  # noqa: E402
    ClassificationTraining as JTask,
)
from nerf_downstream_tpu.train.state import (  # noqa: E402
    TrainState as JTrainState,
)
from nerf_downstream_tpu.utils import calibrate as JC  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.co3d_3d import train as tcli  # noqa: E402
from nerf_downstream_tpu_torch.data.data_module import DataModule  # noqa: E402
from nerf_downstream_tpu_torch.data.synthetic import (  # noqa: E402
    collate_mink,
    make_synthetic_scene,
    write_co3d_tree,
)
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as TW  # noqa: E402
from nerf_downstream_tpu_torch.sparse import kernels as TK  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import PointField  # noqa: E402
from nerf_downstream_tpu_torch.train.loop import to_device  # noqa: E402
from nerf_downstream_tpu_torch.train.modules import (  # noqa: E402
    ClassificationTraining,
)
from nerf_downstream_tpu_torch.utils import calibrate as TC  # noqa: E402

CFG = "co3d_3d/configs"
CLS = [f"{CFG}/co3d_cls.gin", f"{CFG}/co3d_aug2.gin",
       f"{CFG}/feature_sh.gin", f"{CFG}/resnet14.gin"]
# what the reference's CLI binds on its own test's tree and seed, from two
# train batches
REFERENCE_KNOBS = {
    "level_caps": (512, 256, 256, 256, 256), "window_tile": 256,
    "window_size": 128, "window_blocks": 3, "window_cross_blocks": 3,
    "window_expand_factor": 2, "window_escape_cap": (0, 0, 0, 0, 0),
    "window_escape_tiles": (4, 4, 4, 4, 4),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    jcfg.clear_config()
    tcfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jcfg.clear_config()
    tcfg.clear_config()


def reference_test_tree(root) -> tuple:
    """``tests/test_cli_3d.py::write_co3d_tree``'s tree, from the same
    generator state (its ``rng`` fixture)."""
    return write_co3d_tree(str(root), np.random.default_rng(0), n_train=4,
                           n_val=0, n_voxels=300, reso=(32, 32, 32),
                           num_classes=3)


def reference_test_args(data_root, fdir, save) -> list:
    """The reference CLI test's arguments."""
    args = []
    for c in CLS:
        args += ["--ginc", c]
    for b in (f'Co3DDatasetBase.data_root = "{data_root}"',
              f'Co3DDatasetBase.filelist_dir = "{fdir}"',
              "Co3DDatasetBase.downsample_stride = 1",
              "train.max_steps = 3", "train.val_every_n_steps = 2",
              "train.batch_size = 2", "train.val_batch_size = 2",
              "train.train_num_workers = 1", "train.val_num_workers = 1",
              "train.evaluate = True"):
        args += ["--ginb", b]
    return args + ["--save_path", str(save), "--seed", "1"]


# -- calibrate ---------------------------------------------------------------

def test_adjacency_orders_match_reference():
    for n in range(1, 10):
        ours, ref = TC._adjacency_orders(n), JC._adjacency_orders(n)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def _jitted_reference_plans(monkeypatch):
    orig = JW.build_plan_direct

    @functools.lru_cache(maxsize=None)
    def compiled(offs, cross, kw):
        kw = dict(kw)
        offsets = np.asarray(offs, np.int32)
        if cross:
            return jax.jit(lambda c, m, oc, om: orig(
                c, m, offsets, out_coords=oc, out_mask=om, **kw))
        return jax.jit(lambda c, m: orig(c, m, offsets, **kw))

    def plan(coords, mask, offsets, out_coords=None, out_mask=None, **kw):
        fn = compiled(tuple(map(tuple, np.asarray(offsets).tolist())),
                      out_coords is not None, tuple(sorted(kw.items())))
        if out_coords is None:
            return fn(coords, mask)
        return fn(coords, mask, out_coords, out_mask)

    monkeypatch.setattr(JW, "build_plan_direct", plan)


def test_calibrate_matches_reference(monkeypatch):
    """Two batches of two 600-voxel shells at 64^3 (capacity 2048), tile
    64, window 32, one random order each: coverage 6 blocks and escape
    lists at the finest level, integer-equal."""
    _jitted_reference_plans(monkeypatch)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        samples = []
        for _ in range(2):
            sc = make_synthetic_scene(rng, n_voxels=600, reso=(64,) * 3,
                                      surface=True)
            samples.append({"coordinates": sc["coords"].astype(np.float32),
                            "features": sc["sh"],
                            "labels": np.zeros(1, np.int32)})
        batches.append(collate_mink(samples, capacity=2048))
    kw = dict(tile=64, window=32, permutations=1, seed=3)
    ours = TC.calibrate(batches, device="cpu", **kw)
    ref = JC.calibrate(batches, **kw)
    assert ours == ref
    assert ours["window_blocks"] == 6 and ours["window_escape_cap"][0] > 0
    tcfg.parse_config(TC.gin_text(ours))
    assert tuple(tcfg.query_parameter("CoordinateContext.level_caps")) == \
        ours["level_caps"]


@pytest.mark.parametrize("extra", [
    [],
    ["CoordinateContext.level_caps = (4096, 1024, 256, 128, 64)"],
    ["CoordinateContext.window_escape_cap = 64"],
    ['CoordinateContext.method = "row"'],
    ["CoordinateContext.grid_extent = None"],
    ['CoordinateContext.method = "hybrid"',
     "CoordinateContext.grid_extent = None"],
    "scannet",
])
def test_needs_calibration_matches_reference(extra):
    if extra == "scannet":
        files = [f"{CFG}/scannet_plenoxel.gin", f"{CFG}/scannet_feature_sh.gin"]
        extra = []
    else:
        files = CLS
    jcfg.parse_config_files_and_bindings(files, extra)
    tcfg.parse_config_files_and_bindings(files, extra)
    assert TC.needs_calibration() == JC.maybe_auto_calibrate(None,
                                                             dry_run=True)
    assert TC.maybe_auto_calibrate(None, dry_run=True) == \
        TC.needs_calibration()


def test_automatic_calibration_leaves_the_run_stream_alone(tmp_path,
                                                           monkeypatch,
                                                           caplog):
    """``maybe_auto_calibrate`` draws from copies of the run's streams: it
    measures the batches the run then trains on first, and the run's
    batches are those of a run with its knobs pinned, however many the
    calibration drew. When its draws run out before ``FRESH_BATCHES``
    covered batches in a row, it warns."""
    data_root, fdir = reference_test_tree(tmp_path)
    binds = [f'Co3DDatasetBase.data_root = "{data_root}"',
             f'Co3DDatasetBase.filelist_dir = "{fdir}"',
             "Co3DDatasetBase.downsample_stride = 1"]
    measured = []
    measure = TC.calibrate

    def recording_calibrate(batches, **kw):
        measured.append(list(batches))
        return measure(batches, **kw)

    monkeypatch.setattr(TC, "calibrate", recording_calibrate)
    monkeypatch.setattr(TC, "FRESH_BATCHES", 100)
    monkeypatch.setattr(TC, "MAX_DRAWS", 3)

    def first_train_coords(calibrate: bool) -> list:
        tcfg.clear_config()
        tcli.seed_everything(1)
        tcfg.parse_config_files_and_bindings(CLS, binds)
        dm = DataModule(batch_size=2, val_batch_size=2, train_num_workers=1,
                        val_num_workers=1)
        if calibrate:
            with caplog.at_level("WARNING"):
                assert TC.maybe_auto_calibrate(dm, device="cpu")
        it = dm.train_batches()
        return [next(it)["coordinates"] for _ in range(3)]

    pinned = first_train_coords(False)
    calibrated = first_train_coords(True)
    for a, b in zip(pinned, calibrated):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pinned[:2], measured[0][:2]):
        np.testing.assert_array_equal(a, b["coordinates"])
    assert "without 100 in a row" in caplog.text


def test_loader_threads_draw_per_batch(tmp_path, monkeypatch):
    """With more than one loader thread, each train batch draws its host
    transforms from its own generator: two runs with four threads yield
    the same batches, whichever thread loads which when, and the
    automatic calibration (one thread, on copies of the streams) measures
    the batches such a run then trains on."""
    data_root, fdir = reference_test_tree(tmp_path)
    binds = [f'Co3DDatasetBase.data_root = "{data_root}"',
             f'Co3DDatasetBase.filelist_dir = "{fdir}"',
             "Co3DDatasetBase.downsample_stride = 1"]
    measured = []
    measure = TC.calibrate

    def recording_calibrate(batches, **kw):
        measured.append(list(batches))
        return measure(batches, **kw)

    monkeypatch.setattr(TC, "calibrate", recording_calibrate)
    monkeypatch.setattr(TC, "MAX_DRAWS", 2)

    def first_train(calibrate: bool) -> list:
        tcfg.clear_config()
        tcli.seed_everything(1)
        tcfg.parse_config_files_and_bindings(CLS, binds)
        dm = DataModule(batch_size=2, val_batch_size=2, train_num_workers=4,
                        val_num_workers=4)
        if calibrate:
            assert TC.maybe_auto_calibrate(dm, device="cpu")
        it = dm.train_batches()
        return [next(it) for _ in range(4)]

    runs = [first_train(False), first_train(False), first_train(True)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            for k in ("coordinates", "features", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(runs[0][:2], measured[0][:2]):
        np.testing.assert_array_equal(a["coordinates"], b["coordinates"])


# -- the reference's NaN -----------------------------------------------------

def test_reference_knobs_poison_validation_in_both(tmp_path, monkeypatch):
    """On the reference test's tree and seed: the port's calibration of
    the two train batches the reference measures gives the reference's
    knobs; bound in both packages, the first validation batch's logits
    are NaN in both, from a window escape of the stride-1 plan (no level
    lost rows); the third train batch escapes there too. ``covers``
    predicts both."""
    data_root, fdir = reference_test_tree(tmp_path)
    binds = [f'Co3DDatasetBase.data_root = "{data_root}"',
             f'Co3DDatasetBase.filelist_dir = "{fdir}"',
             "Co3DDatasetBase.downsample_stride = 1"]
    tcli.seed_everything(1)
    tcfg.parse_config_files_and_bindings(CLS, binds)
    dm = DataModule(batch_size=2, val_batch_size=2, train_num_workers=1,
                    val_num_workers=1)
    it = dm.train_batches()
    knobs = TC.calibrate([next(it), next(it)], tile=256, window=128,
                         device="cpu")
    assert knobs == REFERENCE_KNOBS
    # the trainer's batches come from a fresh pass over the data
    it = dm.train_batches()
    train = [next(it) for _ in range(3)]
    val = next(dm.val_batches())
    # the coverage check the port's calibration runs says so beforehand
    assert [TC.covers(knobs, b, "cpu") for b in (*train, val)] == [
        True, True, False, False]
    TC.bind(knobs)
    jcfg.parse_config_files_and_bindings(CLS, binds)
    JC.bind(knobs)

    model = get_model(num_batches=2, ctx=None, assume_unique=None)
    variables = convert.init_flax_variables(model, 0)
    convert.load_flax_variables(model, variables)
    escapes, lost = [], []
    build, capped = TW.build_plan_direct, TK.stride_coords_capped

    def plan(coords, mask, offsets, **kw):
        p = build(coords, mask, offsets, **kw)
        if kw.get("out_coords") is None:
            escapes.append((coords.shape[0], int(p.n_escaped)))
        return p

    def level(sv, stride, cap):
        out, n = capped(sv, stride, cap)
        lost.append(int(n))
        return out, n

    monkeypatch.setattr(TW, "build_plan_direct", plan)
    monkeypatch.setattr(TK, "stride_coords_capped", level)
    task = ClassificationTraining(model, scheduler_name="none")
    logits, mets = task.eval_step(task.create_state(), to_device(val, "cpu"))
    assert torch.isnan(logits).all() and np.isnan(float(mets["loss"]))
    assert escapes[0] == (1024, 1) and not any(lost)
    escapes.clear()
    with torch.no_grad():
        b = to_device(train[2], "cpu")
        model(PointField(b["coordinates"], b["features"], b["mask"]))
    assert escapes[0] == (1024, 1)

    jmodel = jget_model(num_batches=2)
    jtask = JTask(jmodel, scheduler_name="none")
    jbatch = {k: jax.numpy.asarray(val[k]) for k in (
        "coordinates", "features", "mask", "labels")}
    state = JTrainState.create(
        jmodel.apply, jax.tree_util.tree_map(jax.numpy.asarray,
                                             variables["params"]),
        jax.tree_util.tree_map(jax.numpy.asarray, variables["batch_stats"]),
        jtask.make_tx())
    ref_logits, ref_mets = jtask.make_eval_step().lower(
        state, jbatch).compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})(state, jbatch)
    assert np.isnan(np.asarray(ref_logits)).all()
    assert np.isnan(float(ref_mets["loss"]))


def test_cli_calibrates_where_the_reference_poisons(tmp_path):
    """The reference CLI test's command through the port's CLI: finite
    validation, the files, and an escape list at the stride-1 level; with
    the reference's knobs bound instead it stops on the NaN."""
    data_root, fdir = reference_test_tree(tmp_path)
    args = reference_test_args(data_root, fdir, tmp_path / "port")
    tcli.main(args + ["--device", "cpu"])
    assert tcfg.query_parameter("CoordinateContext.window_escape_cap")[0] > 0
    for name in ("last.ckpt", "best.ckpt", "eval_results.json"):
        assert os.path.exists(tmp_path / "port" / name)
    res = json.load(open(tmp_path / "port" / "eval_results.json"))
    assert np.isfinite(res["val/loss"]) and "val/acc1" in res

    tcfg.clear_config()
    pinned = [x for k, v in REFERENCE_KNOBS.items()
              for x in ("--ginb", f"CoordinateContext.{k} = {v!r}")]
    with pytest.raises(ValueError, match="Invalid val loss: nan"):
        tcli.main(reference_test_args(data_root, fdir, tmp_path / "pinned")
                  + pinned + ["--device", "cpu"])


def test_cli_classification_at_planes_8(tmp_path):
    """The CLI on the README's classification configs at planes 8 (the
    reference test's tree, ``co3d_aug2``): calibration bound, 3 steps,
    validation at step 2 and the final test pass, ``val/acc1`` logged and
    written, the checkpoints in the reference's layout; then a resume to
    step 4."""
    data_root, fdir = reference_test_tree(tmp_path)
    save = tmp_path / "exp"
    args = reference_test_args(data_root, fdir, save) + [
        "--ginb", "get_model.planes = (8, 8, 8, 8)",
        "--ginb", "get_model.init_dim = 8",
        "--ginb", 'train.loggers = ["csv", "jsonl"]',
        "--ginb", "train.log_every_n_steps = 1",
        "--device", "cpu"]
    tcli.main(args)
    assert tcfg.query_parameter("CoordinateContext.level_caps") is not None
    res = json.load(open(save / "eval_results.json"))
    assert 0 <= res["val/acc1"] <= 100 and np.isfinite(res["val/loss"])
    from nerf_downstream_tpu_torch.train import checkpoints as tck

    ck = tck.load_checkpoint(str(save / "last.ckpt"))
    assert ck["global_step"] == 3
    assert ck["params"]["final"]["kernel"].shape == (8, 51)
    rows = [json.loads(line) for line in open(
        save / "b2x1-MinkResNetBase" / "metrics.jsonl")]
    assert any("val/acc1" in r for r in rows)
    assert all(np.isfinite(r["train/loss"]) for r in rows
               if "train/loss" in r)
    tcfg.clear_config()
    tcli.main([a if a != "train.max_steps = 3" else "train.max_steps = 4"
               for a in args] + ["--resume"])
    assert tck.load_checkpoint(str(save / "last.ckpt"))["global_step"] == 4


def test_offline_calibration_cli_writes_a_gin_file(tmp_path):
    """``co3d_3d.calibrate`` on the reference test's tree: a gin file of
    the eight knobs that the port's engine parses back."""
    from nerf_downstream_tpu_torch.co3d_3d import calibrate as ccli

    data_root, fdir = reference_test_tree(tmp_path)
    out = tmp_path / "calibrated.gin"
    argv = [a for c in CLS for a in ("--ginc", c)]
    for b in (f'Co3DDatasetBase.data_root = "{data_root}"',
              f'Co3DDatasetBase.filelist_dir = "{fdir}"',
              "train.batch_size = 2", "train.val_batch_size = 2"):
        argv += ["--ginb", b]
    ccli.main(argv + ["--samples", "1", "--permute", "1", "--out",
                      str(out), "--device", "cpu"])
    tcfg.clear_config()
    tcfg.parse_config(out.read_text())
    knobs = {k: tcfg.query_parameter(f"CoordinateContext.{k}")
             for k in REFERENCE_KNOBS}
    assert len(knobs["level_caps"]) == 5 and knobs["window_tile"] == 256
    assert knobs["window_blocks"] in TC.BLOCK_CHOICES
