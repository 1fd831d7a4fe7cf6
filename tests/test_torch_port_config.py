"""The port's gin engine, its configurable surfaces and its training-state
checkpoints against the JAX package's, on the CPU.

Every ``.gin`` file of ``co3d_3d/configs`` gives the same ``config_str``
in both engines, and both raise on the same malformed statements; a
binding that names no parameter raises at the call. ``level_cap_decay``
gives the reference's caps at every stride. A training state written by
the JAX package after two momentum-SGD steps restores into the port
(weights, BatchNorm statistics, momentum buffers and step), and a port
state restores through the reference's ``restore_into``; the optimizer
then takes the same next step in both.
"""

import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402

CONFIGS = sorted(glob.glob("co3d_3d/configs/*.gin"))


@pytest.fixture(autouse=True)
def _clean():
    jcfg.clear_config()
    tcfg.clear_config()
    yield
    jcfg.clear_config()
    tcfg.clear_config()


def test_every_repo_config_parses_as_the_reference_does():
    assert len(CONFIGS) >= 28
    for path in CONFIGS:
        jcfg.clear_config()
        tcfg.clear_config()
        jcfg.parse_config_files_and_bindings([path], ["train.lr = 0.5"])
        tcfg.parse_config_files_and_bindings([path], ["train.lr = 0.5"])
        assert tcfg.config_str() == jcfg.config_str(), path
        assert tcfg.query_parameter("train.lr") == 0.5


def test_check_bindings_takes_every_class_of_a_name():
    """The 2D and the 3D ``RandomHorizontalFlip`` share a name: with both
    modules imported, a binding passes ``check_bindings`` when either
    class takes the parameter (the one registered first included), and
    still raises when neither does."""
    import importlib

    for mod in ("transforms", "transforms2d"):
        importlib.import_module(f"nerf_downstream_tpu_torch.data.{mod}")
    for binding in ('RandomHorizontalFlip.upright_axis = "y"',
                    "RandomHorizontalFlip.p = 0.5"):
        tcfg.clear_config()
        tcfg.parse_config_files_and_bindings([], [binding])
        tcfg.check_bindings()
    tcfg.clear_config()
    tcfg.parse_config_files_and_bindings(
        [], ["RandomHorizontalFlip.nonsense = 1"])
    with pytest.raises(tcfg.ConfigError, match="nonsense"):
        tcfg.check_bindings()
    tcfg.clear_config()


def test_every_repo_config_applies_in_the_port():
    """Every binding of every config names a configurable of the port and
    one of its parameters (``modelnet40_cls.gin`` binds ``PerlinNoise``'s,
    which its pipeline does not list: the port has that transform now),
    and its dataset resolves; ``modelnet40_cls.gin`` among them, with its
    ModelNet40 reader."""
    import importlib

    from nerf_downstream_tpu_torch.data.datasets import get_dataset
    from nerf_downstream_tpu_torch.data.modelnet40 import ModelNet40H5Dataset

    for mod in ("co3d_3d.train", "co3d_3d.eval", "data.co3d",
                "data.modelnet40", "data.scannet", "data.transforms",
                "models", "models.mink.powernorm", "sparse.context",
                "train.optim"):
        importlib.import_module(f"nerf_downstream_tpu_torch.{mod}")
    for path in CONFIGS:
        tcfg.clear_config()
        tcfg.parse_config_files_and_bindings([path], [])
        tcfg.check_bindings()
        assert get_dataset() is not None, path
        if path.endswith("modelnet40_cls.gin"):
            assert get_dataset() is ModelNet40H5Dataset
    from nerf_downstream_tpu_torch.data.transforms import PerlinNoise

    assert tcfg.get_configurable("PerlinNoise") is PerlinNoise


def test_later_wins_includes_macros_and_refs(tmp_path):
    (tmp_path / "base.gin").write_text(
        "A = 3\nf.x = %A\nf.y = [1,\n  2]  # comment\nf.z = @g\n")
    (tmp_path / "top.gin").write_text(
        "include 'base.gin'\nf.x = 4\nf.w = '#not a comment'\n")
    for cfg in (jcfg, tcfg):
        cfg.parse_config_files_and_bindings([str(tmp_path / "top.gin")],
                                            ["f.y = (5,)"])
    assert tcfg.config_str() == jcfg.config_str()
    assert tcfg.query_parameter("f.x") == 4
    assert tcfg.query_parameter("f.y") == (5,)


@pytest.mark.parametrize("stmt", [
    "just words", "f.x = (1, 2", "f.x = foo()", "f.x = @", "f.x = [1,,2]",
    "f.x = %UNDEFINED_LATER",
])
def test_malformed_statements_raise_in_both(stmt):
    errors = []
    for cfg in (jcfg, tcfg):
        try:
            cfg.parse_config(stmt)
            cfg.query_parameter("f.x")
            errors.append(None)
        except Exception as e:  # the type is what must agree
            errors.append(type(e).__name__)
    assert errors[0] == errors[1]
    assert errors[1] is not None


def test_binding_that_names_no_parameter_raises():
    from nerf_downstream_tpu_torch.sparse.context import CoordinateContext
    from nerf_downstream_tpu_torch.train.optim import get_optimizer

    tcfg.parse_config("CoordinateContext.window_sise = 128\n")
    with pytest.raises(tcfg.ConfigError, match="window_sise"):
        CoordinateContext()
    tcfg.clear_config()
    tcfg.parse_config("SGD.momentun = 0.9\n")
    with pytest.raises(tcfg.ConfigError, match="momentun"):
        get_optimizer("SGD", [torch.zeros(2, requires_grad=True)], 0.1)


def test_gin_surfaces_bind_the_port():
    from nerf_downstream_tpu_torch.models import get_model
    from nerf_downstream_tpu_torch.sparse.context import CoordinateContext
    from nerf_downstream_tpu_torch.train.optim import get_optimizer

    tcfg.parse_config_files_and_bindings(
        ["co3d_3d/configs/scannet_plenoxel.gin",
         "co3d_3d/configs/scannet_feature_sh.gin"],
        ["Res16UNet.PLANES = (8, 8, 8, 8, 8, 8, 8, 8)"])
    ctx = CoordinateContext()
    assert (ctx.grid_extent, ctx.window_size, ctx.window_blocks,
            ctx.level_cap_decay, ctx.block_cap_divisor) == (320, 128, 4,
                                                            0.5, 3)
    assert ctx.use_window_full()
    model = get_model(num_batches=8, ctx=None, assume_unique=None)
    assert model.planes == (8,) * 8 and model.layers == (2,) * 8
    assert model.num_batches == 8 and model.out_channel == 20
    opt = get_optimizer("SGD", model.parameters(), 0.1, 1e-4)
    assert opt.param_groups[0]["momentum"] == 0.9
    tcfg.parse_config("Adam.b2 = 0.98\n")
    adam = get_optimizer("Adam", model.parameters(), 0.1)
    assert adam.param_groups[0]["b2"] == 0.98
    with pytest.raises(ValueError, match="not recognized"):
        get_optimizer("LARS", model.parameters(), 0.1)


@pytest.mark.parametrize("decay,tile", [(0.5, 256), (0.3, 64), (0.9, 128)])
def test_level_cap_decay_matches_reference(decay, tile):
    from nerf_downstream_tpu.sparse.context import CoordinateContext as JC
    from nerf_downstream_tpu_torch.sparse.context import CoordinateContext

    ours = CoordinateContext(level_cap_decay=decay, window_tile=tile)
    ref = JC(level_cap_decay=decay, window_tile=tile)
    for cap in (1024, 8192, 65536, 131072, 1000):
        for in_stride in (1, 2, 4, 8):
            for stride in (in_stride * 2 ** k for k in range(5)):
                assert ours.level_cap(stride, cap, in_stride) == \
                    ref.level_cap(stride, cap, in_stride)
    both = dict(level_cap_decay=decay, level_caps=(4096, 1024, 256))
    assert CoordinateContext(**both).level_cap(2, 8192) == \
        JC(**both).level_cap(2, 8192) == 1024
    assert CoordinateContext().level_cap(2, 8192) is None


def test_window_cross_blocks_sizes_cross_plans(rng):
    """Cross-set plans take ``window_cross_blocks`` coverage blocks (times
    ``window_expand_factor`` when expanding), same-set plans keep
    ``window_blocks``; unbound, cross plans follow ``window_blocks``."""
    from nerf_downstream_tpu_torch.sparse import kernels as tk
    from nerf_downstream_tpu_torch.sparse.context import CoordinateContext
    from nerf_downstream_tpu_torch.sparse.types import SparseVoxels

    coords = np.unique(rng.integers(0, 16, (600, 3)), axis=0)
    key = coords[:, 0] * 256 + coords[:, 1] * 16 + coords[:, 2]
    coords = coords[np.argsort(key)]
    c = np.zeros((640, 4), np.int64)  # padded to whole tiles
    c[:len(coords), 1:] = coords
    sv = SparseVoxels(coords=torch.as_tensor(c, dtype=torch.int32),
                      feats=torch.zeros(640, 1),
                      mask=torch.arange(640) < len(coords), stride=1)
    offs = tk.kernel_offsets(2, 1)
    for cross, want in ((None, 2), (5, 5)):
        ctx = CoordinateContext(method="hybrid", window_tile=64,
                                window_size=32, window_blocks=2,
                                window_expand_factor=3,
                                window_cross_blocks=cross)
        coarse = ctx.strided(sv, 2)
        down = ctx.window_plan_cross(sv, coarse, offs, expanding=True)
        up = ctx.window_plan_cross(coarse, sv, offs, transpose=True)
        same = ctx.window_plan_direct(sv.coords, sv.mask,
                                      tk.kernel_offsets(3, 1))
        assert (down.blocks, up.blocks, same.blocks) == (3 * want, want, 2)


def _train_two_steps_jax(seed=0):
    import jax
    import jax.numpy as jnp
    import optax

    from nerf_downstream_tpu.train.optim import sgd
    from nerf_downstream_tpu.train.state import TrainState

    rng = np.random.default_rng(seed)
    params = {"w": jnp.asarray(rng.normal(size=(3, 4)), jnp.float32),
              "b": {"kernel": jnp.asarray(rng.normal(size=(5,)),
                                          jnp.float32)}}
    stats = {"bn": {"mean": jnp.asarray(rng.normal(size=4), jnp.float32)}}
    tx = sgd(optax.cosine_decay_schedule(0.1, 10), weight_decay=1e-4,
             momentum=0.9)
    state = TrainState.create(None, params, stats, tx)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
            params)
        state = state.apply_gradients(grads)
    return state


def test_sgd_state_carries_across_both_ways(tmp_path):
    """A two-step momentum-SGD state with weight decay and a schedule,
    written by the JAX package, loads into a torch SGD as its momentum
    buffers (and back), within 1e-7."""
    from nerf_downstream_tpu.train import checkpoints as jck
    from nerf_downstream_tpu_torch.train import checkpoints as tck

    state = _train_two_steps_jax()
    path = str(tmp_path / "j.ckpt")
    jck.save_checkpoint(path, state)
    raw = tck.load_checkpoint(path)
    assert raw["global_step"] == 2
    trace = raw["opt_state"]["1"]["0"]["trace"]
    assert int(raw["opt_state"]["1"]["1"]["count"]) == 2
    np.testing.assert_allclose(
        trace["w"], np.asarray(state.opt_state[1][0].trace["w"]), atol=1e-7)
    # and the port writes what the reference reads back
    written = tck.packb({"state_dict": {"params": raw["params"],
                                        "batch_stats": raw["batch_stats"]},
                         "optimizer_states": raw["opt_state"],
                         "global_step": 2, "meta": {}})
    path2 = str(tmp_path / "t.ckpt")
    with open(path2, "wb") as f:
        f.write(written)
    back = jck.restore_into(_train_two_steps_jax(1), jck.load_checkpoint(
        path2), weights=True, optimizer=True)
    for a, b in zip(*(map(np.asarray, __import__("jax").tree_util
                          .tree_leaves(s.opt_state)) for s in (back,
                                                                 state))):
        np.testing.assert_array_equal(a, b)


def _port_state(planes=(8,) * 8, seed=0):
    from nerf_downstream_tpu_torch.models import get_model
    from nerf_downstream_tpu_torch.train.modules import (
        SegmentationTraining,
        init_variables,
    )

    model = get_model("Res16UNet14", in_channel=27, out_channel=20,
                      planes=planes, ctx=dict(method="hybrid"))
    init_variables(model, seed)
    task = SegmentationTraining(model, optimizer_name="SGD",
                                scheduler_name="PolyLR", lr=0.1,
                                weight_decay=1e-4,
                                scheduler_kwargs={"max_steps": 10})
    tcfg.parse_config("SGD.momentum = 0.9\n")
    state = task.create_state()
    return task, state


def test_training_state_resumes_in_the_reference_and_back(tmp_path):
    """A training state of the model written by the JAX package after two
    momentum-SGD steps (weight decay, a schedule) restores into the port:
    weights, batch statistics, momentum buffers and step within 1e-7.
    Written back by the port (``save_training_state``), it restores
    through the reference's ``restore_into`` bit for bit. Then both take
    the same next step within 1e-6."""
    import jax
    import jax.numpy as jnp

    from nerf_downstream_tpu.train import checkpoints as jck
    from nerf_downstream_tpu.train.optim import sgd
    from nerf_downstream_tpu.train.state import TrainState
    from nerf_downstream_tpu_torch import convert
    from nerf_downstream_tpu_torch.train import checkpoints as tck

    task, state = _port_state()
    tree = convert.init_flax_variables(state.model, 3)
    tx = sgd(lambda s: 0.1 * (1 - s / 11) ** 0.9, weight_decay=1e-4,
             momentum=0.9)
    jstate = TrainState.create(None, jax.tree_util.tree_map(
        jnp.asarray, tree["params"]), tree["batch_stats"], tx)
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
            jstate.params)
        jstate = jstate.apply_gradients(grads)
    path = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(path, jstate)

    raw = tck.load_checkpoint(path)
    tck.restore_into(state, raw, weights=True, optimizer=True)
    state.step = int(raw["global_step"])
    assert state.step == 2
    want = convert.state_dict_to_flax(state.model.state_dict())
    for coll in ("params", "batch_stats"):
        for a, b in zip(jax.tree_util.tree_leaves(want[coll]),
                        jax.tree_util.tree_leaves(getattr(
                            jstate, coll))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)
    bufs = convert.state_dict_to_flax(
        {n: state.optimizer.state[p]["momentum_buffer"]
         for n, p in state.model.named_parameters()})["params"]
    for a, b in zip(jax.tree_util.tree_leaves(bufs),
                    jax.tree_util.tree_leaves(jstate.opt_state[1][0].trace)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)

    path2 = str(tmp_path / "port.ckpt")
    tck.save_training_state(path2, state)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    back = jck.restore_into(zeros, jck.load_checkpoint(path2), weights=True,
                            optimizer=True)
    for a, b in zip(jax.tree_util.tree_leaves((back.params,
                                               back.batch_stats,
                                               back.opt_state)),
                    jax.tree_util.tree_leaves((jstate.params,
                                               jstate.batch_stats,
                                               jstate.opt_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jck.load_checkpoint(path2)["global_step"] == 2

    # one more step from both, on the same gradients
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.5),
                                   jstate.params)
    jnext = jstate.apply_gradients(grads)
    for group in state.optimizer.param_groups:
        group["lr"] = state.lr(task.lr)
    for p in state.model.parameters():
        p.grad = torch.full_like(p, 0.5)
    state.optimizer.step()
    got = convert.state_dict_to_flax(state.model.state_dict())["params"]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jnext.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
