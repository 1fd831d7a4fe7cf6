"""The port's fused 2D+3D ensemble (``models/ensemble.py``,
``data/joint.py``, ``EnsembleClassificationTraining``) against the JAX
package's, on the CPU.

- ``Ensemble2D3D`` (ResNet18 images, ResNet14 voxels, at the
  reference's widths) under both fusions, on 2 scenes of 32x32 images
  and 1,024 rows, from the reference's variables carried across by
  ``convert.py`` (the tree's structure and shapes equal to the
  reference's ``init``): eval logits within 1e-5 of the largest.
- One ``EnsembleClassificationTraining`` step (SGD, lr 0.01, "logit"
  fusion, 128x128 images) in both packages from one state: the loss within 1e-5
  (relative), each updated leaf and running statistic within 1e-4 of its
  largest entry, and both branches' leaves moved.
- ``JointCo3DDataset`` items and ``collate_joint`` batches equal to the
  reference's on a ``write_joint_tree`` tree (images exactly, rows
  exactly), a scene without frames included.
- An ensemble training checkpoint written by each package loads in the
  other.

The reference runs its XLA path (``NDT_WINDOW_PALLAS=0``), jitted at
XLA's lowest optimization level; the port its plain versions.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.models.ensemble import (  # noqa: E402
    Ensemble2D3D as JEnsemble,
)
from nerf_downstream_tpu.models.interface import (  # noqa: E402
    process_input as jprocess,
)
from nerf_downstream_tpu.train import checkpoints as jck  # noqa: E402
from nerf_downstream_tpu.train.modules import (  # noqa: E402
    EnsembleClassificationTraining as JTask,
)
from nerf_downstream_tpu.train.state import (  # noqa: E402
    TrainState as JTrainState,
)
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.data import synthetic  # noqa: E402
from nerf_downstream_tpu_torch.models.ensemble import (  # noqa: E402
    Ensemble2D3D,
    make_ensemble,
)
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from nerf_downstream_tpu_torch.train.modules import (  # noqa: E402
    EnsembleClassificationTraining,
    get_training_module,
)

CLASSES, SCENES, IMAGE, STEP_IMAGE, CAP, CHANNELS = 6, 2, 32, 128, 1024, 27
KNOBS = dict(
    method="hybrid", grid_extent=64,
    level_caps=(1024, 512, 256, 128, 64),
    window_tile=64, window_size=64, window_blocks=2,
    window_expand_factor=3,
    window_escape_cap=(2048, 1024, 512, 256, 256),
    window_escape_tiles=(288, 144, 72, 36, 36),
)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    jcfg.clear_config()
    tcfg.clear_config()
    lines = ["field_to_sparse.assume_unique = True"]
    lines += [f"CoordinateContext.{k} = {v!r}" for k, v in KNOBS.items()]
    jcfg.parse_config("\n".join(lines) + "\n")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jcfg.clear_config()
    tcfg.clear_config()


def close_to_largest(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def make_batch(seed=0, image=IMAGE):
    """Two shells of about 300 voxels in 1,024 rows with SH features,
    ``image`` x ``image`` images and labels."""
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(SCENES):
        sc = synthetic.make_synthetic_scene(rng, n_voxels=300,
                                            reso=(40,) * 3, surface=True)
        samples.append({
            "coordinates": sc["coords"].astype(np.float32),
            "features": sc["sh"].astype(np.float32),
            "labels": np.array([(2 * i + 1) % CLASSES], np.int32),
        })
    batch = synthetic.collate_mink(samples, capacity=CAP)
    batch["labels"] = np.array([s["labels"][0] for s in samples], np.int32)
    batch["images"] = rng.uniform(0, 1, (SCENES, image, image, 3)).astype(
        np.float32)
    return batch


def port_model(fusion):
    return Ensemble2D3D(in_channels=CHANNELS, out_channel=CLASSES,
                        num_batches=SCENES, fusion=fusion, ctx=KNOBS,
                        assume_unique=True)


@functools.lru_cache(maxsize=None)
def reference_shapes(fusion):
    """The leaf shapes of the reference's ``init`` (traced, not run)."""
    batch = make_batch()
    jmodel = JEnsemble(out_channel=CLASSES, num_batches=SCENES,
                       fusion=fusion)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.asarray(batch["images"]),
                            jprocess(batch), train=False))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), shapes)


def both(fusion, seed=1):
    """The reference's and the port's model with one set of random
    variables (flax layout), whose structure and shapes are the
    reference's own."""
    jmodel = JEnsemble(out_channel=CLASSES, num_batches=SCENES,
                       fusion=fusion)
    model = port_model(fusion)
    variables = convert.init_flax_variables(model, seed)
    assert reference_shapes(fusion) == jax.tree_util.tree_map(np.shape,
                                                              variables)
    convert.load_flax_variables(model, variables)
    return jmodel, model, variables


@functools.lru_cache(maxsize=None)
def reference_eval():
    """Both fusions' eval logits in the reference, with the same image
    and voxel branches: the "feature" model jitted (its branches'
    outputs captured), then the "logit" model's own fusion on those
    outputs (its branches' calls intercepted), so that the branches
    compile once."""
    import flax.linen as fnn

    batch = make_batch()
    _, _, vl = both("logit")
    _, _, vf = both("feature", seed=2)
    for coll in ("params", "batch_stats"):
        for branch in ("image", "voxel"):
            vf[coll][branch] = vl[coll][branch]
    jl = JEnsemble(out_channel=CLASSES, num_batches=SCENES, fusion="logit")
    jf = JEnsemble(out_channel=CLASSES, num_batches=SCENES, fusion="feature")

    def run(v, im, f):
        return jf.apply(v, im, f, train=False, mutable=["intermediates"],
                        capture_intermediates=lambda m, method: (
                            m.name in ("image", "voxel")
                            and method == "__call__"))

    images = jnp.asarray(batch["images"])
    args = (jax.tree_util.tree_map(jnp.asarray, vf), images,
            jprocess(batch))
    feature, inter = jax.jit(run).lower(*args).compile(
        compiler_options=FAST_XLA)(*args)
    branch = {k: inter["intermediates"][k]["__call__"][0]
              for k in ("image", "voxel")}

    def replay(next_fun, a, kw, context):
        if context.method_name == "__call__" and \
                context.module.name in branch:
            return branch[context.module.name]
        return next_fun(*a, **kw)

    with fnn.intercept_methods(replay):
        logit = jl.apply(jax.tree_util.tree_map(jnp.asarray, vl), images,
                         jprocess(batch), train=False)
    return batch, {"logit": (vl, np.asarray(logit)),
                   "feature": (vf, np.asarray(feature))}


def torch_batch(batch):
    out = {k: torch.as_tensor(batch[k]) for k in
           ("coordinates", "features", "mask", "images")}
    out["labels"] = torch.as_tensor(batch["labels"]).long()
    return out


@pytest.mark.parametrize("fusion", ["logit", "feature"])
def test_ensemble_eval_matches_reference(fusion):
    batch, refs = reference_eval()
    variables, ref = refs[fusion]
    model = convert.load_flax_variables(port_model(fusion), variables)
    task = EnsembleClassificationTraining(model, scheduler_name="none")
    logits, _ = task.eval_step(task.create_state(), torch_batch(batch))
    assert logits.shape == (SCENES, CLASSES)
    close_to_largest(logits.numpy(), ref, 1e-5, fusion)
    # the reference's name, through the registries
    assert get_training_module("EnsembleClassificationTraining") \
        is EnsembleClassificationTraining
    assert isinstance(make_ensemble(in_channels=4, fusion=fusion),
                      Ensemble2D3D)


def test_ensemble_step_matches_reference():
    """At 128x128 images: at 32x32 the image branch's last stage is 1x1,
    so its train-mode BatchNorm sees 2 values per channel, where the
    reference's one-pass variance (E[x^2] - E[x]^2 in f32) cancels: its
    step loss then moves by 0.9 % between two XLA optimization levels
    (measured on the CPU), at 128x128 by 1e-7."""
    batch = make_batch(image=STEP_IMAGE)
    jmodel, model, variables = both("logit", seed=2)
    # a nonzero mix, so that both branches' logits reach the loss
    variables["params"]["fusion_alpha"] = np.float32(0.3)
    convert.load_flax_variables(model, variables)
    jtask = JTask(jmodel, optimizer_name="SGD", scheduler_name="none",
                  lr=0.01)
    jstate = JTrainState.create(
        jmodel.apply, jax.tree_util.tree_map(jnp.asarray,
                                             variables["params"]),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        jtask.make_tx())
    jbatch = {k: jnp.asarray(batch[k]) for k in (
        "coordinates", "features", "mask", "labels", "images")}
    ref_state, ref_mets = jtask.make_train_step(donate=False).lower(
        jstate, jbatch).compile(compiler_options=FAST_XLA)(jstate, jbatch)
    ref_after = convert.flax_to_state_dict(model, {
        "params": jax.device_get(ref_state.params),
        "batch_stats": jax.device_get(ref_state.batch_stats)})

    task = EnsembleClassificationTraining(model, optimizer_name="SGD",
                                          scheduler_name="none", lr=0.01)
    state = task.create_state()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, mets = task.train_step(state, torch_batch(batch))
    assert np.isfinite(float(mets["loss"]))
    np.testing.assert_allclose(float(mets["loss"]), float(ref_mets["loss"]),
                               rtol=1e-5)
    for key, v in model.state_dict().items():
        close_to_largest(v.numpy(), ref_after[key].numpy(), 1e-4, key)
    for key in ("image.conv1.kernel", "voxel.conv1.kernel",
                "image_head.kernel", "voxel.final.kernel", "fusion_alpha"):
        assert not torch.equal(before[key], model.state_dict()[key]), key


def test_joint_dataset_and_collate_match_reference(tmp_path):
    from nerf_downstream_tpu.data.joint import (
        JointCo3DDataset as JJoint,
        collate_joint as jcollate,
    )
    from nerf_downstream_tpu_torch.data.joint import (
        JointCo3DDataset,
        collate_joint,
    )

    data_root, fdir, frames = synthetic.write_joint_tree(
        str(tmp_path), np.random.default_rng(0), frame_size=(48, 40),
        n_train=3, n_val=1, n_voxels=200, reso=(48, 48, 48))
    # one scene without frames: a black image in both packages
    with open(os.path.join(fdir, "train.txt")) as f:
        cls, inst = f.readline().split()
    for name in os.listdir(os.path.join(frames, cls, inst, "fgbg")):
        os.remove(os.path.join(frames, cls, inst, "fgbg", name))
    for phase in ("train", "val"):
        kw = dict(data_root=data_root, frames_root=frames, image_size=32,
                  filelist_dir=fdir)
        ref, got = JJoint(phase, **kw), JointCo3DDataset(phase, **kw)
        assert len(ref) == len(got) > 0
        items = []
        for i in range(len(ref)):
            a, b = ref[i], got[i]
            assert b["image"].dtype == np.float32
            np.testing.assert_array_equal(b["image"], a["image"])
            for k in ("coordinates", "features", "labels"):
                np.testing.assert_array_equal(b[k], a[k])
            items.append((a, b))
        if phase == "train":
            assert not got[0]["image"].any() and got[1]["image"].any()
        ja = jcollate([a for a, _ in items], capacity=2048)
        tb = collate_joint([b for _, b in items], capacity=2048)
        assert tb["images"].shape == (len(items), 32, 32, 3)
        for k in ("images", "coordinates", "features", "mask", "labels"):
            np.testing.assert_array_equal(tb[k], ja[k])


def test_ensemble_checkpoints_cross_packages(tmp_path):
    """A training checkpoint of the port loads into the reference's state
    and one of the reference's into the port's, leaf for leaf, with the
    optimizer's momentum trace."""
    tcfg.parse_config("SGD.momentum = 0.9\n")
    jcfg.parse_config("SGD.momentum = 0.9\n")
    jmodel, model, variables = both("feature", seed=3)
    task = EnsembleClassificationTraining(model, scheduler_name="none",
                                          lr=0.01)
    state = task.create_state()
    for n, p in model.named_parameters():  # a nonzero momentum trace
        state.optimizer.state[p]["momentum_buffer"] = torch.full_like(p, 0.5)
    state.step = 3
    path = str(tmp_path / "port.ckpt")
    tck.save_training_state(path, state)

    jtask = JTask(jmodel, scheduler_name="none", lr=0.01)
    jstate = JTrainState.create(
        jmodel.apply, jax.tree_util.tree_map(jnp.zeros_like,
                                             variables["params"]),
        jax.tree_util.tree_map(jnp.zeros_like, variables["batch_stats"]),
        jtask.make_tx())
    raw = jck.load_checkpoint(path)
    jstate = jck.restore_into(jstate, raw, weights=True, optimizer=True)
    got = convert.flax_to_state_dict(model, {
        "params": jax.device_get(jstate.params),
        "batch_stats": jax.device_get(jstate.batch_stats)})
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)
    # SGD with momentum behind the default weight decay's
    # add_decayed_weights: (decay, (trace, schedule))
    trace = jax.device_get(jstate.opt_state[1][0].trace)
    assert all(np.all(a == 0.5) for a in jax.tree_util.tree_leaves(trace))
    assert int(raw["global_step"]) == 3

    # the reference's checkpoint into a fresh port model
    jpath = str(tmp_path / "ref.ckpt")
    jck.save_checkpoint(jpath, jstate.replace(step=jnp.asarray(5)))
    fresh = port_model("feature")
    ftask = EnsembleClassificationTraining(
        fresh, scheduler_name="none", lr=0.01, checkpoint_path=jpath,
        load_weights=True, load_optimizers=True)
    fstate = ftask.create_state()
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      model.state_dict()[k].numpy(), k)
    assert all(bool((fstate.optimizer.state[p]["momentum_buffer"]
                     == 0.5).all()) for p in fresh.parameters())
