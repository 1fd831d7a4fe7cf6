"""The port's IN, LN and PowerNorm against the JAX package's, on the CPU.

- ``MinkLayerNorm`` and ``MinkInstanceNorm`` (with ``layer_norm`` and
  ``instance_norm_stats``) on rows with padding: output, d_feats,
  d_scale and d_bias on the valid rows within 1e-5 x the largest entry.
- ``MinkPowerNorm`` over 3 train steps with ``warmup_iters`` bound to 2,
  so the steps fall on both sides of it: the output, d_x, d_weight,
  d_bias, ``ema_gz``, ``running_phi`` and ``iters`` within 1e-5, the
  reference's values from its custom VJP through ``split_ema_state`` and
  ``merge_ema_state``, as its train step takes them; garbage in the
  padding rows changes nothing; then eval mode.
- ``convert_powernorm_state`` against the JAX function.
- Res16UNet14AIns (planes of 8) with PN: eval-mode logits and the insseg
  offsets within 1e-5 x their largest, on weights carried by
  ``convert.py`` with every norm drawn away from identity (the
  reference applies the port's tree, so every name must match); one SGD
  step (lr 0.1) of Res16UNet14's segmentation task with IN, LN and PN
  (IN and LN compute the same in train and eval mode, so this holds
  their forward too): the loss within 1e-5 relative, every gradient
  within 1e-4 x
  its leaf's largest (the f32 sums of the two backward passes run in
  different orders: the measured gaps reach 5e-5), and every parameter
  and statistic after the step within 1e-5 x its leaf's largest entry
  plus lr x that gradient bound.
- A PowerNorm training state written by the port restores into the JAX
  package and back, ``iters`` as int32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nerf_downstream_tpu import config as cfg  # noqa: E402
from nerf_downstream_tpu.models import get_model as jax_get_model  # noqa: E402
from nerf_downstream_tpu.models.mink import layers as JL  # noqa: E402
from nerf_downstream_tpu.models.mink import powernorm as JPN  # noqa: E402
from nerf_downstream_tpu.models.interface import process_input  # noqa: E402
from nerf_downstream_tpu.ops import norm as JN  # noqa: E402
from nerf_downstream_tpu.sparse.types import SparseVoxels as JSV  # noqa: E402
from nerf_downstream_tpu.train.modules import (  # noqa: E402
    SegmentationTraining as JTask,
    merge_ema_state,
    split_ema_state,
)
from nerf_downstream_tpu.train.state import (  # noqa: E402
    TrainState as JTrainState,
)
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.models.mink import layers as TL  # noqa: E402
from nerf_downstream_tpu_torch.models.mink import powernorm as TPN  # noqa: E402
from nerf_downstream_tpu_torch.ops import norm as TN  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import (  # noqa: E402
    PointField,
    SparseVoxels,
)
from nerf_downstream_tpu_torch.train.modules import (  # noqa: E402
    SegmentationTraining,
)
from tests.test_torch_port_model import (  # noqa: E402
    CLASSES,
    KNOBS,
    bindings,
    make_batch,
)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    # the reference's XLA fallback of its window convs (its Pallas
    # kernels' interpreted forms are held to the port elsewhere)
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    cfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    cfg.clear_config()


def close(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def rows(rng, n=60, c=6, scenes=2, valid=45):
    """Rows of ``scenes`` scenes with ``n - valid`` padding rows (junk
    features, batch index 0) and a cotangent."""
    coords = np.zeros((n, 4), np.int32)
    coords[:valid, 0] = np.sort(rng.integers(0, scenes, valid))
    coords[:, 1:] = rng.integers(0, 50, (n, 3))
    feats = (rng.normal(size=(n, c)) * 2 + 0.5).astype(np.float32)
    mask = np.arange(n) < valid
    gy = rng.normal(size=(n, c)).astype(np.float32)
    return coords, feats, mask, gy


@pytest.mark.parametrize("kind", ["LN", "IN"])
def test_layer_and_instance_norm_match_reference(rng, kind):
    coords, feats, mask, gy = rows(rng)
    c = feats.shape[1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    if kind == "LN":
        jmod, tmod = JL.MinkLayerNorm(), TL.MinkLayerNorm(c)
    else:
        jmod, tmod = (JL.MinkInstanceNorm(num_batches=2),
                      TL.MinkInstanceNorm(c, num_batches=2))

    def jfn(f, s, b):
        sv = JSV(coords=jnp.asarray(coords), feats=f, mask=jnp.asarray(mask))
        out = jmod.apply({"params": {"scale": s, "bias": b}}, sv).feats
        return jnp.sum(jnp.where(jnp.asarray(mask)[:, None], out, 0)
                       * jnp.asarray(gy)), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(feats), jnp.asarray(scale), jnp.asarray(bias))
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(scale))
        tmod.bias.copy_(torch.from_numpy(bias))
    f = torch.from_numpy(feats).requires_grad_(True)
    sv = SparseVoxels(coords=torch.from_numpy(coords), feats=f,
                      mask=torch.from_numpy(mask))
    out = tmod(sv).feats
    (torch.where(sv.mask[:, None], out, 0) * torch.from_numpy(gy)).sum() \
        .backward()
    close(out.detach().numpy()[mask], np.asarray(jout)[mask], what="out")
    close(f.grad.numpy()[mask], np.asarray(jgrads[0])[mask], what="d_x")
    close(tmod.weight.grad, jgrads[1], what="d_scale")
    close(tmod.bias.grad, jgrads[2], what="d_bias")
    if kind == "IN":  # the function itself, padding in the spare segment
        bid = np.where(mask, coords[:, 0], 2).astype(np.int32)
        jm, jv = JN.instance_norm_stats(jnp.asarray(feats), jnp.asarray(bid),
                                        2)
        tm, tv = TN.instance_norm_stats(torch.from_numpy(feats),
                                        torch.from_numpy(bid), 2)
        close(tm, jm, what="mean")
        close(tv, jv, what="var")
    else:
        close(TN.layer_norm(torch.from_numpy(feats), torch.from_numpy(scale),
                            torch.from_numpy(bias)),
              JN.layer_norm(jnp.asarray(feats), scale, bias), what="ln")


def test_powernorm_train_steps_match_reference(rng):
    c, warmup = 6, 2
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    jmod = JPN.MinkPowerNorm(warmup_iters=warmup)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"running_phi": jnp.asarray(rng.uniform(0.5, 2.0, c)
                                        .astype(np.float32)),
             "iters": jnp.zeros((), jnp.int32),
             "ema_gz": jnp.zeros((c,), jnp.float32)}
    tmod = TPN.MinkPowerNorm(c, warmup_iters=warmup).train()
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(scale))
        tmod.bias.copy_(torch.from_numpy(bias))
        tmod.running_phi.copy_(torch.tensor(
            np.asarray(stats["running_phi"])))

    def jstep(stats, coords, feats, mask, gy):
        flat, ema = split_ema_state({"pn": stats})

        def loss(p, ema_in, f):
            bs = dict(flat)
            bs.update(ema_in)
            from flax import traverse_util

            sv = JSV(coords=jnp.asarray(coords), feats=f,
                     mask=jnp.asarray(mask))
            out, mut = jmod.apply(
                {"params": p,
                 "batch_stats": traverse_util.unflatten_dict(bs)["pn"]},
                sv, True, mutable=["batch_stats"])
            return jnp.sum(out.feats * jnp.asarray(gy)), (out.feats,
                                                          mut["batch_stats"])

        (_, (out, new)), (gp, new_ema, gx) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(params, ema,
                                                   jnp.asarray(feats))
        new = merge_ema_state({"pn": new}, new_ema)["pn"]
        return out, gx, gp, new

    for step in range(3):
        coords, feats, mask, gy = rows(rng, c=c)
        jout, jgx, jgp, stats = jstep(stats, coords, feats, mask, gy)
        junk = feats.copy()
        junk[~mask] = 1e3  # padding rows must not count
        f = torch.from_numpy(junk).requires_grad_(True)
        sv = SparseVoxels(coords=torch.from_numpy(coords), feats=f,
                          mask=torch.from_numpy(mask))
        tmod.weight.grad = tmod.bias.grad = None
        out = tmod(sv).feats
        (out * torch.from_numpy(np.where(mask[:, None], gy, 0))).sum() \
            .backward()
        what = f"step {step}"
        close(out.detach().numpy()[mask], np.asarray(jout)[mask],
              what=f"{what} out")
        close(f.grad.numpy()[mask], np.asarray(jgx)[mask], what=f"{what} dx")
        assert (f.grad.numpy()[~mask] == 0).all()
        close(tmod.weight.grad, jgp["scale"], what=f"{what} d_weight")
        close(tmod.bias.grad, jgp["bias"], what=f"{what} d_bias")
        for leaf in ("running_phi", "ema_gz"):
            close(getattr(tmod, leaf), stats[leaf], what=f"{what} {leaf}")
        assert tmod.iters.dtype == torch.int32
        assert int(tmod.iters) == int(stats["iters"]) == step + 1
    assert float(np.abs(np.asarray(stats["ema_gz"])).max()) > 0
    # eval mode: division by running_phi
    coords, feats, mask, _ = rows(rng, c=c)
    sv = JSV(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
             mask=jnp.asarray(mask))
    jout = jmod.apply({"params": params, "batch_stats": stats}, sv, False)
    with torch.no_grad():
        tout = tmod.eval()(SparseVoxels(
            coords=torch.from_numpy(coords), feats=torch.from_numpy(feats),
            mask=torch.from_numpy(mask)))
    close(tout.feats.numpy()[mask], np.asarray(jout.feats)[mask],
          what="eval")


def test_convert_powernorm_state_matches_reference(rng):
    params = {"scale": rng.normal(size=5).astype(np.float32),
              "bias": rng.normal(size=5).astype(np.float32)}
    bn = {"mean": rng.normal(size=5).astype(np.float32),
          "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    jp, js = JPN.convert_powernorm_state(params, bn)
    tp, ts = TPN.convert_powernorm_state(params, bn)
    assert jp.keys() == tp.keys() and js.keys() == ts.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    for k in js:
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]))
    assert ts["iters"].dtype == np.int32


def randomise(tree, rng):
    """Every norm drawn away from identity: scale, bias and each
    statistic."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomise(v, rng)
        elif k in ("var", "running_phi"):
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean", "bias", "ema_gz"):
            out[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def both_models(name, norm_type):
    cfg.parse_config(bindings())
    jmodel = jax_get_model(name=name, out_channel=CLASSES, num_batches=2,
                           planes=(8,) * 8, norm_type=norm_type)
    model = get_model(name, in_channel=27, out_channel=CLASSES,
                      planes=(8,) * 8, norm_type=norm_type, num_batches=2,
                      ctx=KNOBS, assume_unique=True)
    return jmodel, model


def tensors(batch):
    return PointField(coords=torch.as_tensor(batch["coordinates"]),
                      feats=torch.as_tensor(batch["features"]),
                      mask=torch.as_tensor(batch["mask"]))


def test_res16unet_ins_powernorm_eval_matches_reference():
    jmodel, model = both_models("Res16UNet14AIns", "PN")
    batch = make_batch()
    variables = randomise(convert.init_flax_variables(model, 0),
                          np.random.default_rng(1))
    ref_off, ref = jax.jit(lambda v, f: jmodel.apply(v, f, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), process_input(batch))
    convert.load_flax_variables(model, variables)
    with torch.no_grad():
        off, got = model.eval()(tensors(batch))
    mask = batch["mask"]
    assert off.shape[-1] == 3
    close(off.numpy()[mask], np.asarray(ref_off)[mask], what="offsets")
    close(got.numpy()[mask], np.asarray(ref)[mask], what="logits")


@pytest.mark.parametrize("norm_type", ["IN", "LN", "PN"])
def test_res16unet_norms_sgd_step_matches_reference(norm_type):
    jmodel, model = both_models("Res16UNet14", norm_type)
    cfg.parse_config("field_to_sparse.assume_unique = False\n")
    model.assume_unique = False
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if k in ("coordinates", "features", "mask", "labels")}
    variables = randomise(convert.init_flax_variables(model, 1),
                          np.random.default_rng(2))
    convert.load_flax_variables(model, variables)
    jtask = JTask(jmodel, scheduler_name="none", lr=0.1, ignore_label=-100)

    def stash_grads():  # keeps the step's gradients in the optimizer state
        return optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))

    jstate = JTrainState.create(
        jmodel.apply,
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jax.tree_util.tree_map(jnp.asarray,
                               variables.get("batch_stats", {})),
        optax.chain(stash_grads(), jtask.make_tx()))
    step = jtask.make_train_step(donate=False).lower(jstate, jbatch).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    jstate, jmets = step(jstate, jbatch)
    task = SegmentationTraining(model, scheduler_name="none", lr=0.1,
                                ignore_label=-100)
    state = task.create_state()
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()
              if k in ("coordinates", "features", "mask")}
    tbatch["labels"] = torch.as_tensor(batch["labels"]).long()
    state, mets = task.train_step(state, tbatch)
    np.testing.assert_allclose(float(mets["loss"]), float(jmets["loss"]),
                               rtol=1e-5)
    grads = convert.flax_to_state_dict(
        model, jax.device_get(jstate.opt_state[0]))
    for key, p in model.named_parameters():
        close(p.grad.numpy(), grads[key].numpy(), tol=1e-4, what=key)
    want = convert.flax_to_state_dict(model, {
        "params": jax.device_get(jstate.params),
        "batch_stats": jax.device_get(jstate.batch_stats)})
    got = model.state_dict()
    assert set(want) == set(got)
    for key in got:
        if key.endswith("iters"):
            assert int(got[key]) == int(want[key]) == 1, key
            continue
        atol = 1e-5 * float(want[key].abs().max())
        if key in grads:
            atol += 0.1 * 1e-4 * float(grads[key].abs().max())
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=0, atol=atol, err_msg=key)


def test_powernorm_training_state_resumes_both_ways(tmp_path):
    """A PN training state written by the port (after one step, so every
    statistic moved) restores through the reference's ``restore_into``
    into a state of the JAX PN model bit for bit, ``iters`` as int32;
    written back by the JAX package, it restores into a fresh port model
    bit for bit."""
    from nerf_downstream_tpu.train import checkpoints as jck
    from nerf_downstream_tpu_torch.train import checkpoints as tck

    jmodel, model = both_models("Res16UNet14", "PN")
    batch = make_batch()
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()
              if k in ("coordinates", "features", "mask")}
    tbatch["labels"] = torch.as_tensor(batch["labels"]).long()
    convert.load_flax_variables(model, convert.init_flax_variables(model, 4))
    task = SegmentationTraining(model, scheduler_name="none", lr=0.1,
                                ignore_label=-100)
    state = task.create_state()
    state, _ = task.train_step(state, tbatch)
    path = str(tmp_path / "pn.ckpt")
    tck.save_training_state(path, state)

    jtask = JTask(jmodel, scheduler_name="none", lr=0.1, ignore_label=-100)
    jstate = jtask.create_state(jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in batch.items()
        if k in ("coordinates", "features", "mask")})
    jstate = jck.restore_into(jstate, jck.load_checkpoint(path),
                              weights=True, optimizer=True)
    pn = jax.device_get(jstate.batch_stats["MinkPowerNorm_3"])
    assert sorted(pn) == ["ema_gz", "iters", "running_phi"]
    assert np.asarray(pn["iters"]).dtype == np.int32
    assert int(pn["iters"]) == 1
    # MinkPowerNorm_3 is the fourth unit's norm (conv2)
    np.testing.assert_array_equal(pn["ema_gz"],
                                  model.conv2.norm.ema_gz.numpy())
    assert float(np.abs(pn["ema_gz"]).max()) > 0
    back = str(tmp_path / "back.ckpt")
    jck.save_checkpoint(back, jstate)
    _, fresh = both_models("Res16UNet14", "PN")
    ftask = SegmentationTraining(fresh, scheduler_name="none", lr=0.1,
                                 ignore_label=-100)
    fstate = ftask.create_state()
    tck.restore_into(fstate, tck.load_checkpoint(back), weights=True,
                     optimizer=True)
    for key, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], v), key
    assert fresh.conv2.norm.iters.dtype == torch.int32
