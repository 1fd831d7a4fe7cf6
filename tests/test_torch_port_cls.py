"""The port's 3D classification slice against the JAX package, on the CPU.

- The CO3D host transforms (``CoordinateJitter``,
  ``CoordinateUniformTranslation``, ``RandomScale``,
  ``VoxelDownsampleSimple``, ``DensityBasedSample``): the same arrays from
  the same seed, exactly.
- The CO3D reader on a ``write_co3d_tree`` tree, through the
  ``co3d_aug3.gin`` transform list: coordinates, features and labels
  exactly.
- ``window_pool`` (sum, avg, max) and ``global_pool`` (avg, max, sum)
  within 1e-6.
- The k1/s2 conv (cross-set window plans), the k3/s2 conv (the row path:
  kernel map, K6's plain version, the inverse-map backward) and the k2/s2
  sum pooling: output and gradients within 1e-5 of the largest value.
- ResNet14 (``BasicBlock``) and ResNet50 (``Bottleneck``) at planes
  (8, 8, 8, 8) on three scenes: eval logits within 1e-4 x max|logit|;
  one ``ClassificationTraining`` step's loss within 1e-5 (relative), its
  gradients and the updated weights within 1e-5 of each parameter's
  largest entry.
- ``topk_accuracy``, the step loss and the validation sums with a padded
  ``sample_mask``; weights both ways, with checkpoints written by each
  package read by the other.

The reference runs its XLA fallback (``NDT_WINDOW_PALLAS=0``): its Pallas
kernels are held against the port's plain versions in interpret mode by
the other port tests.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.data import co3d as JCO  # noqa: E402
from nerf_downstream_tpu.data import transforms as JT  # noqa: E402
from nerf_downstream_tpu.models import get_model as jget_model  # noqa: E402
from nerf_downstream_tpu.models.mink.layers import (  # noqa: E402
    SparseConv as JConv,
    SparsePool as JPool,
)
from nerf_downstream_tpu.ops import pool as JP  # noqa: E402
from nerf_downstream_tpu.sparse import field_to_sparse as jf2s  # noqa: E402
from nerf_downstream_tpu.sparse.context import (  # noqa: E402
    CoordinateContext as JCtx,
)
from nerf_downstream_tpu.sparse.types import PointField as JField  # noqa: E402
from nerf_downstream_tpu.train import checkpoints as jck  # noqa: E402
from nerf_downstream_tpu.train import metrics as JM  # noqa: E402
from nerf_downstream_tpu.train.modules import (  # noqa: E402
    ClassificationTraining as JTask,
)
from nerf_downstream_tpu.train.state import (  # noqa: E402
    TrainState as JTrainState,
)
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.data import co3d as TCO  # noqa: E402
from nerf_downstream_tpu_torch.data import synthetic  # noqa: E402
from nerf_downstream_tpu_torch.data import transforms as TT  # noqa: E402
from nerf_downstream_tpu_torch.data.datasets import get_dataset  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.models.mink.layers import (  # noqa: E402
    SparseConv,
    SparsePool,
)
from nerf_downstream_tpu_torch.ops import pool as TP  # noqa: E402
from nerf_downstream_tpu_torch.sparse import (  # noqa: E402
    CoordinateContext,
    field_to_sparse,
)
from nerf_downstream_tpu_torch.sparse.types import PointField  # noqa: E402
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from nerf_downstream_tpu_torch.train import metrics as TM  # noqa: E402
from nerf_downstream_tpu_torch.train.modules import (  # noqa: E402
    ClassificationTraining,
    classification_loss,
)

CLASSES = 51
# window knobs of the small tests: tight windows with escape lists (the
# stem conv's plan sends 14 entries there); the row path's kernel maps go
# through the dense grid
KNOBS = dict(
    method="hybrid", grid_extent=64,
    level_caps=(2048, 1024, 512, 256, 128),
    window_tile=64, window_size=64, window_blocks=2,
    window_expand_factor=3,
    window_escape_cap=(4096, 1024, 1024, 256, 256),
    window_escape_tiles=(288, 144, 72, 36, 36),
)
# XLA's CPU backend at its lowest optimization level: the same arithmetic,
# compiled in about half the time
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
AUG3 = ["RandomRotation", "RandomAffine", "CoordinateDropout",
        "RandomHorizontalFlip", "CoordinateUniformTranslation",
        "CoordinateJitter", "RandomScale", "RandomFeatureJitter"]


def bind_knobs():
    lines = ["field_to_sparse.assume_unique = True"]
    lines += [f"CoordinateContext.{k} = {v!r}" for k, v in KNOBS.items()]
    jcfg.parse_config("\n".join(lines) + "\n")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    jcfg.clear_config()
    tcfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jcfg.clear_config()
    tcfg.clear_config()


def make_batch(seed=0, scenes=3, voxels=500, cap=2048, reso=48):
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(scenes):
        sc = synthetic.make_synthetic_scene(rng, n_voxels=voxels,
                                            reso=(reso,) * 3, surface=True)
        samples.append({
            "coordinates": sc["coords"].astype(np.float32),
            "features": sc["sh"].astype(np.float32),
            "labels": np.array([(7 * i + 3) % CLASSES], np.int32),
        })
    return synthetic.collate_mink(samples, capacity=cap)


def fields(batch, seed=1, channels=27):
    """The batch's point field in both packages, with random features."""
    feats = np.random.default_rng(seed).normal(
        size=(batch["coordinates"].shape[0], channels)).astype(np.float32)
    jf = JField(coords=jnp.asarray(batch["coordinates"]),
                feats=jnp.asarray(feats), mask=jnp.asarray(batch["mask"]))
    tf = PointField(coords=torch.as_tensor(batch["coordinates"]),
                    feats=torch.as_tensor(feats),
                    mask=torch.as_tensor(batch["mask"]))
    return jf, tf


def close_to_largest(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# -- transforms and the reader ----------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("CoordinateJitter", {}),
    ("CoordinateUniformTranslation", {"max_translation": 0.2}),
    ("RandomScale", {"scale_ratio": 0.4}),
    ("VoxelDownsampleSimple", {"stride": 2}),
    ("DensityBasedSample", {"percentile": 0.95, "density_dim": 3}),
])
def test_transforms_match_reference(name, kw):
    rng = np.random.default_rng(5)
    coords = rng.integers(0, 64, (400, 3)).astype(np.float32)
    feats = rng.normal(size=(400, 31)).astype(np.float32)
    JT.seed(11)
    TT.seed(11)
    jt, tt = JT.TRANSFORMS[name](**kw), TT.TRANSFORMS[name](**kw)
    for _ in range(6):  # both branches of the application gates
        rc, rf, _ = jt(coords.copy(), feats.copy(), None)
        pc, pf, _ = tt(coords.copy(), feats.copy(), None)
        np.testing.assert_array_equal(pc, rc)
        np.testing.assert_array_equal(pf, rf)
    assert name in TT.COORD_AFFECTING


@pytest.mark.parametrize("downsample", [None, 0, 1])
def test_co3d_reader_matches_reference(tmp_path, downsample):
    root, fdir = synthetic.write_co3d_tree(
        str(tmp_path), np.random.default_rng(0), n_train=3, n_val=2,
        n_voxels=300, reso=(32, 32, 32), num_classes=5)
    assert get_dataset("Co3DDataset") is TCO.Co3DDataset
    kw = dict(data_root=root, filelist_dir=fdir,
              train_transformations=AUG3,
              features=["xyzs", "density", "sh", "ones"])
    if downsample is not None:
        kw.update(apply_downsample=True, downsample_mode=downsample,
                  downsample_stride=2)
    for phase, n in (("train", 3), ("val", 2)):
        JT.seed(3)
        TT.seed(3)
        ref = JCO.Co3DDataset(phase, **kw)
        ours = TCO.Co3DDataset(phase, **kw)
        assert len(ours) == len(ref) == n
        for i in range(n):
            a, b = ref[i], ours[i]
            for key in ("coordinates", "features", "xyzs", "labels"):
                np.testing.assert_array_equal(b[key], a[key], err_msg=key)
            assert b["metadata"] == a["metadata"]
    assert ours[0]["labels"][0] == TCO.CLASSES_IDX[TCO.CLASSES[3]]


# -- pooling and the strided layers -----------------------------------------

@pytest.mark.parametrize("mode", ["sum", "avg", "max"])
def test_pools_match_reference(mode):
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(300, 6)).astype(np.float32)
    km = rng.integers(0, 360, (8, 200)).astype(np.int32)
    km = np.minimum(km, 300)  # ~1/6 sentinels
    km[:, :5] = 300  # empty windows
    ref = np.asarray(JP.window_pool(jnp.asarray(feats), jnp.asarray(km),
                                    mode))
    got = TP.window_pool(torch.as_tensor(feats), torch.as_tensor(km), mode)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    gmode = {"sum": "avg", "avg": "max", "max": "sum"}[mode]
    ids = rng.integers(0, 5, 300).astype(np.int32)  # 4 = padding
    ids[ids == 2] = 4  # an element with no rows
    ref = np.asarray(JP.global_pool(jnp.asarray(feats), jnp.asarray(ids), 4,
                                    gmode))
    got = TP.global_pool(torch.as_tensor(feats), torch.as_tensor(ids), 4,
                         gmode)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


class _JLayer(fnn.Module):
    kind: str

    @fnn.compact
    def __call__(self, field):
        ctx = JCtx(num_batches=3)
        sv, _ = jf2s(field)
        if self.kind == "pool":
            out = JPool(2, 2, "sum", name="pool")(sv, ctx)
        else:
            k = 1 if self.kind == "k1s2" else 3
            out = JConv(16, k, 2, name="conv")(sv, ctx)
        return out.masked_feats(), out.coords, out.mask


@pytest.mark.parametrize("kind", ["k1s2", "k3s2", "pool"])
def test_strided_layers_match_reference(kind):
    bind_knobs()
    batch = make_batch()
    jf, tf = fields(batch, channels=8)
    layer = _JLayer(kind)
    variables = jax.jit(layer.init)(jax.random.PRNGKey(0), jf)
    params = variables.get("params", {})
    shape = jax.eval_shape(layer.apply, variables, jf)[0].shape
    r = np.random.default_rng(4).normal(size=shape).astype(np.float32)

    def fwd_bwd(params, feats):
        def loss(params, feats):
            out = layer.apply({"params": params}, jf.replace(feats=feats))
            return jnp.sum(out[0] * r), out
        return jax.grad(loss, argnums=(0, 1), has_aux=True)(params, feats)

    (g_params, g_feats), (ref_f, ref_c, ref_m) = jax.jit(fwd_bwd).lower(
        params, jf.feats).compile(compiler_options=FAST_XLA)(params,
                                                             jf.feats)

    ctx = CoordinateContext(num_batches=3, **KNOBS)
    feats = tf.feats.clone().requires_grad_(True)
    sv, _ = field_to_sparse(PointField(tf.coords, feats, tf.mask),
                            assume_unique=True)
    if kind == "pool":
        mod = SparsePool(2, 2, "sum")
    else:
        mod = SparseConv(8, 16, 1 if kind == "k1s2" else 3, 2)
        with torch.no_grad():
            mod.kernel.copy_(torch.tensor(
                np.asarray(params["conv"]["kernel"])))
    out = mod(sv, ctx)
    if kind != "pool":
        assert mod.route == {"k1s2": "windowed", "k3s2": "row"}[kind]
    np.testing.assert_array_equal(out.coords.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref_m))
    got = out.masked_feats()
    close_to_largest(got.detach().numpy(), ref_f, 1e-5, "forward")
    (got * torch.as_tensor(r)).sum().backward()
    close_to_largest(feats.grad.numpy(), g_feats, 1e-5, "d_feats")
    if kind != "pool":
        close_to_largest(mod.kernel.grad.numpy(),
                         g_params["conv"]["kernel"], 1e-5, "d_w")


# -- the ResNets and the task ------------------------------------------------

def randomise_norms(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomise_norms(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def models(name):
    """The reference's and the port's model, with one set of random
    weights and norm statistics, and the reference's state for it."""
    bind_knobs()
    batch = make_batch()
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("coordinates", "features", "mask", "labels")}
    jmodel = jget_model(name=name, out_channel=CLASSES, num_batches=3,
                        planes=(8, 8, 8, 8), init_dim=8)
    model = get_model(name, in_channel=27, out_channel=CLASSES,
                      planes=(8, 8, 8, 8), init_dim=8, num_batches=3,
                      ctx=KNOBS, assume_unique=True)
    variables = randomise_norms(convert.init_flax_variables(model, 1),
                                np.random.default_rng(2))
    convert.load_flax_variables(model, variables)
    return batch, jbatch, jmodel, model, variables


def check_eval(name):
    batch, jbatch, jmodel, model, variables = models(name)
    jtask = JTask(jmodel, scheduler_name="none")
    state = JTrainState.create(
        jmodel.apply,
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        jtask.make_tx())
    ref_logits, ref_mets = jtask.make_eval_step().lower(
        state, jbatch).compile(compiler_options=FAST_XLA)(state, jbatch)
    ref_logits = np.asarray(ref_logits)

    task = ClassificationTraining(model, scheduler_name="none")
    tbatch = {k: torch.as_tensor(batch[k]) for k in
              ("coordinates", "features", "mask")}
    tbatch["labels"] = torch.as_tensor(batch["labels"]).long()
    logits, mets = task.eval_step(task.create_state(), tbatch)
    assert logits.shape == (3, CLASSES)
    close_to_largest(logits.numpy(), ref_logits, 1e-4, "logits")
    np.testing.assert_allclose(float(mets["loss"]), float(ref_mets["loss"]),
                               rtol=1e-5)
    for k in ("acc1", "acc5"):
        assert float(mets[k]) == float(ref_mets[k])


def check_step(name, spread=False):
    """One SGD step (lr 0.1, momentum 0.9 as ``co3d_cls.gin`` binds it, no
    schedule) of the whole classification task: the loss within 1e-5, the
    running statistics within 1e-5 of each one's largest entry, and each
    gradient and updated parameter within 1e-5 of its largest entry.

    With ``spread`` the reference's step is also compiled at XLA's default
    optimization level, and a leaf on which the reference's two steps
    differ by more than 1e-5 of its largest entry (f32 rounding that the
    reference does not reproduce itself) is held to twice that measured
    spread instead."""
    batch, jbatch, jmodel, model, variables = models(name)
    jcfg.parse_config("SGD.momentum = 0.9\n")
    tcfg.parse_config("SGD.momentum = 0.9\n")
    jtask = JTask(jmodel, scheduler_name="none", lr=0.1)

    def stash_grads():
        return optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))

    jstate = JTrainState.create(
        jmodel.apply,
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        optax.chain(stash_grads(), jtask.make_tx()))
    lowered = jtask.make_train_step(donate=False).lower(jstate, jbatch)

    def reference_step(compiler_options):
        ref_state, ref_mets = lowered.compile(
            compiler_options=compiler_options)(jstate, jbatch)
        grads = convert.flax_to_state_dict(
            model, jax.device_get(ref_state.opt_state[0]))
        after = convert.flax_to_state_dict(model, {
            "params": jax.device_get(ref_state.params),
            "batch_stats": jax.device_get(ref_state.batch_stats)})
        return grads, after, ref_mets

    ref_grads, ref_after, ref_mets = reference_step(FAST_XLA)
    limit = {("grad", k): 1e-5 for k in ref_grads}
    limit.update({("after", k): 1e-5 for k in ref_after})
    if spread:
        alt_grads, alt_after, _ = reference_step({})
        for kind, ref, alt in (("grad", ref_grads, alt_grads),
                               ("after", ref_after, alt_after)):
            for k in ref:
                if "running" not in k:
                    own = float((ref[k] - alt[k]).abs().max()
                                / ref[k].abs().max())
                    limit[kind, k] = max(1e-5, 2 * own)

    task = ClassificationTraining(model, scheduler_name="none", lr=0.1)
    state = task.create_state()
    assert state.optimizer.param_groups[0]["momentum"] == 0.9
    tbatch = {k: torch.as_tensor(batch[k]) for k in
              ("coordinates", "features", "mask")}
    tbatch["labels"] = torch.as_tensor(batch["labels"]).long()
    state, mets = task.train_step(state, tbatch)
    assert np.isfinite(float(mets["loss"]))
    np.testing.assert_allclose(float(mets["loss"]),
                               float(ref_mets["loss"]), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(ref_grads)
    for key, g in grads.items():
        close_to_largest(g.numpy(), ref_grads[key].numpy(),
                         limit["grad", key], key)
    for key, v in model.state_dict().items():
        close_to_largest(v.numpy(), ref_after[key].numpy(),
                         limit["after", key], key)


def test_resnet14_eval_matches_reference():
    check_eval("ResNet14")


def test_resnet14_step_matches_reference():
    check_step("ResNet14")


# -- metrics, the validation sums, checkpoints --------------------------------

def test_topk_and_validation_sums_match_reference():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(8, CLASSES)).astype(np.float32)
    labels = rng.integers(0, CLASSES, 8).astype(np.int32)
    labels[:3] = np.argsort(-logits[:3], -1)[:, 2]  # top-5 hits, not top-1
    labels[3] = np.argmax(logits[3])
    sample_mask = np.arange(8) < 6  # a ragged last batch of 6
    ref = JM.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels))
    got = TM.topk_accuracy(torch.as_tensor(logits), torch.as_tensor(labels))
    for k in ("acc1", "acc5"):
        assert float(got[k]) == float(ref[k])
    pred = np.argmax(logits, -1)
    pred[5] = 255
    assert float(TM.precision_at_one(torch.as_tensor(pred),
                                     torch.as_tensor(labels))) == float(
        JM.precision_at_one(jnp.asarray(pred), jnp.asarray(labels)))

    jtask = JTask(jget_model(name="ResNet14", out_channel=CLASSES),
                  scheduler_name="none")
    task = ClassificationTraining(
        get_model("ResNet14", in_channel=27, out_channel=CLASSES),
        scheduler_name="none")
    jb = {"labels": labels, "sample_mask": sample_mask}
    tb = {"labels": torch.as_tensor(labels).long(),
          "sample_mask": torch.as_tensor(sample_mask)}
    ref_loss, ref_acc = jtask.loss_and_metrics(jnp.asarray(logits), jb)
    loss, acc = task.loss_and_metrics(torch.as_tensor(logits), tb)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    assert {k: float(v) for k, v in acc.items()} == {
        k: float(v) for k, v in ref_acc.items()}
    # a model sized for a larger train batch: its spare scene slots are
    # left out (the reference's step needs the two to be equal)
    wide = np.concatenate([logits, rng.normal(size=(8, CLASSES))], 0)
    loss_w, acc_w = classification_loss(torch.as_tensor(wide),
                                        tb["labels"], tb["sample_mask"])
    assert float(loss_w) == float(loss) and float(acc_w["acc1"]) == float(
        acc["acc1"])
    with pytest.raises(ValueError, match="scene slots"):
        classification_loss(torch.as_tensor(logits[:4]), tb["labels"])

    for t in (jtask, task):
        t.on_validation_start()
    for lo, hi in ((0, 8), (0, 8)):
        jtask.validation_batch_end(jnp.asarray(logits[lo:hi]), jb)
        task.validation_batch_end(torch.as_tensor(logits[lo:hi]), tb)
    np.testing.assert_array_equal(task.validation_sums(),
                                  jtask.validation_sums())
    steps = [{"loss": 1.5}, {"loss": 2.5}]
    assert task.validation_epoch_end(steps, "") == \
        jtask.validation_epoch_end(steps, "")


def test_resnet_weights_and_checkpoints_cross_packages(tmp_path):
    """A ResNet50's variables through the port and back are the same
    arrays, and each package reads the other's checkpoint file."""
    model = get_model("ResNet50", in_channel=27, out_channel=CLASSES,
                      planes=(8, 8, 8, 8), init_dim=8)
    tree = convert.init_flax_variables(model, 7)
    convert.load_flax_variables(model, tree)
    back = convert.state_dict_to_flax(model.state_dict(),
                                      convert.flax_layout(model))
    assert dict(flat(back)).keys() == dict(flat(tree)).keys()
    for k, v in flat(tree):
        np.testing.assert_array_equal(dict(flat(back))[k], v)
    assert tree["params"]["final"]["kernel"].shape == (32, CLASSES)
    bind_knobs()
    batch = make_batch()
    jmodel = jget_model(name="ResNet50", out_channel=CLASSES, num_batches=3,
                        planes=(8, 8, 8, 8), init_dim=8)
    ref = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), JField(
        coords=jnp.asarray(batch["coordinates"]),
        feats=jnp.asarray(batch["features"]),
        mask=jnp.asarray(batch["mask"]))))
    want = {k: v.shape for k, v in flat({c: ref[c] for c in (
        "params", "batch_stats")})}
    assert want == {k: v.shape for k, v in flat(tree)}
    assert set(tree["params"]["layer1_block0"]) == {
        "conv1", "conv2", "conv3", "downsample_conv", "MaskedBatchNorm_0",
        "MaskedBatchNorm_1", "MaskedBatchNorm_2", "MaskedBatchNorm_3"}

    port_ckpt = str(tmp_path / "port.ckpt")
    tck.save_checkpoint(port_ckpt, back["params"], back["batch_stats"])
    raw = jck.load_checkpoint(port_ckpt)
    for coll in ("params", "batch_stats"):
        got = dict(flat(raw[coll]))
        for k, v in flat(tree[coll]):
            np.testing.assert_array_equal(got[k], v)

    jax_ckpt = str(tmp_path / "jax.ckpt")
    jstate = JTrainState.create(
        lambda *a, **k: None,
        jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"]),
        optax.sgd(0.1))
    jck.save_checkpoint(jax_ckpt, jstate)
    other = get_model("ResNet50", in_channel=27, out_channel=CLASSES,
                      planes=(8, 8, 8, 8), init_dim=8)
    ck = tck.load_checkpoint(jax_ckpt)
    convert.load_flax_variables(other, {"params": ck["params"],
                                        "batch_stats": ck["batch_stats"]})
    for k, v in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, rtol=0, atol=0)
    assert os.path.getsize(jax_ckpt) > 0
