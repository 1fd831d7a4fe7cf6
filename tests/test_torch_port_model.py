"""The port's Res16UNet against the JAX package's, end to end on the CPU.

A small Res16UNet14 (planes of 8, one block per stage, 1024 rows) is
initialised by the reference, its batch statistics and BatchNorm affine
parameters are drawn at random, and the same variable trees go through
``convert.load_flax_variables`` into the port. Both evaluate the same
collated batch with the same window knobs (tight windows and escape caps
at every level, so the escape list is busy): the eval-mode logits must
agree within 1e-4, and the eval step's loss, overall accuracy and
confusion histogram must agree (the histogram exactly).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu import config as cfg  # noqa: E402
from nerf_downstream_tpu.models import get_model as jax_get_model  # noqa: E402
from nerf_downstream_tpu.train import metrics as JM  # noqa: E402
from nerf_downstream_tpu.train.modules import (  # noqa: E402
    SegmentationTraining,
)
from nerf_downstream_tpu_torch import convert, serve  # noqa: E402
from nerf_downstream_tpu_torch.data import synthetic  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402

CLASSES = 20
KNOBS = dict(
    method="hybrid",
    level_caps=(1024, 512, 256, 128, 64),
    window_tile=64, window_size=32, window_blocks=2,
    window_expand_factor=3,
    window_escape_cap=(8192, 2048, 256, 0, 0),
    window_escape_tiles=(144, 72, 36, 2, 2),
)


def bindings() -> str:
    lines = ['CoordinateContext.method = "hybrid"',
             "field_to_sparse.assume_unique = True"]
    lines += [f"CoordinateContext.{k} = {v!r}" for k, v in KNOBS.items()]
    return "\n".join(lines) + "\n"


@pytest.fixture(autouse=True)
def _setup():
    cfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    cfg.clear_config()


def make_batch(seed=0, scenes=2, voxels=440):
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(scenes):
        sc = synthetic.make_synthetic_scene(
            rng, n_voxels=voxels, reso=(32, 32, 32), with_labels=True,
            num_classes=CLASSES, surface=True)
        samples.append({
            "coordinates": sc["coords"].astype(np.float32),
            "features": np.concatenate([sc["density"], sc["sh"]],
                                       1)[:, 1:28].astype(np.float32),
            "labels": sc["labels"],
        })
    batch = synthetic.collate_mink(samples, capacity=1024)
    batch["labels"][::17] = -100  # some ignored points
    return batch


def randomise_norms(tree, rng):
    """Random BatchNorm statistics and affine parameters, so every norm of
    the eval forward does work."""
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


def n_leaves(tree) -> int:
    return sum(n_leaves(v) if isinstance(v, dict) else 1
               for v in tree.values())


def test_res16unet_eval_matches_reference(monkeypatch):
    # the reference's XLA fallback: its Pallas kernels in interpret mode
    # cost a minute of tracing here, and the per-module tests hold each
    # kernel's interpreted form against the port already
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    cfg.parse_config(bindings())
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if k in ("coordinates", "features", "mask", "labels")}
    jmodel = jax_get_model(name="Res16UNet14", out_channel=CLASSES,
                           num_batches=2, planes=(8,) * 8)
    task = SegmentationTraining(jmodel, scheduler_name="none",
                                ignore_label=-100)
    state = task.create_state(jax.random.PRNGKey(0), jbatch)
    rng = np.random.default_rng(1)
    variables = {
        "params": randomise_norms(jax.device_get(state.params), rng),
        "batch_stats": randomise_norms(jax.device_get(state.batch_stats),
                                       rng),
    }
    state = state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    ref_logits, ref_mets = task.make_eval_step()(state, jbatch)
    ref_logits = np.asarray(ref_logits)

    model = get_model("Res16UNet14", in_channel=27, out_channel=CLASSES,
                      planes=(8,) * 8, ctx=KNOBS,
                      assume_unique=True)
    convert.load_flax_variables(model, variables)
    assert len(model.state_dict()) == n_leaves(variables)
    logits, mets = serve.eval_step(model.eval(), batch)

    mask = batch["mask"]
    assert np.isfinite(ref_logits[mask]).all()
    np.testing.assert_allclose(logits.numpy()[mask], ref_logits[mask],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(mets["loss"]), float(ref_mets["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mets["oa"]), float(ref_mets["OA"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mets["mIoU"]), float(ref_mets["mIoU"]),
                               rtol=1e-5)
    labels = jnp.asarray(batch["labels"])
    valid = jnp.asarray(mask) & (labels != -100)
    pred = jnp.argmax(jnp.asarray(ref_logits), -1)
    ref_hist = JM.fast_hist(jnp.where(valid, pred, CLASSES + 1),
                            jnp.where(valid, labels, CLASSES + 1), CLASSES)
    np.testing.assert_array_equal(mets["hist"].numpy(), np.asarray(ref_hist))


def test_escape_free_knobs_change_nothing():
    """The port's logits do not depend on how the window knobs split the
    work between windows and the escape list (a reference-free check of
    the escape side path inside the whole model)."""
    batch = make_batch()
    logits = []
    for knobs in (KNOBS, dict(KNOBS, window_size=256, window_blocks=4,
                              window_escape_cap=None)):
        model = get_model("Res16UNet14", in_channel=27, out_channel=CLASSES,
                          planes=(8,) * 8, ctx=knobs,
                          assume_unique=True)
        convert.load_flax_variables(model,
                                    convert.init_flax_variables(model, 3))
        logits.append(serve.eval_step(model.eval(), batch)[0])
    mask = torch.as_tensor(batch["mask"])
    assert torch.isfinite(logits[0][mask]).all()
    torch.testing.assert_close(logits[0][mask], logits[1][mask], rtol=1e-5,
                               atol=1e-5)
