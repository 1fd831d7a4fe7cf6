"""The port's optimizers (``train/optim.py``) against the JAX package's
optax ones, on the CPU.

- Each of the nine optimizers (and RMSprop with momentum), with weight
  decay 0 and 1e-4 (AdamW: 0 and its 1e-2), over 5 steps under a
  warm-up cosine schedule (Rprop: a constant lr, its initial step size;
  the reference's Rprop refuses a schedule) on random leaves and
  gradients: every leaf within 1e-6 of its largest entry after each step
  in f32, 1e-12 in f64.
- Each optimizer's state crosses both ways through the optax layout
  (msgpack bytes of either package, ``restore_into`` as
  ``load_optimizers`` calls it) after 2 steps, and the third step is
  equal within the same 1e-6.
- One ``ClassificationTraining`` step of a small ResNet14 with AdamW in
  both packages: the loss within 1e-5 (relative), every leaf within 1e-4
  of its largest entry.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization as fser  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.train import optim as JO  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.models.mink.resnet import (  # noqa: E402
    make_resnet,
)
from nerf_downstream_tpu_torch.train import checkpoints as tck  # noqa: E402
from nerf_downstream_tpu_torch.train import optim as TO  # noqa: E402
from nerf_downstream_tpu_torch.train.state import TrainState  # noqa: E402

LR, WARMUP, T_MAX, STEPS = 0.05, 2, 6, 5
# (name, gin bindings of both packages)
CASES = [("SGD", ("SGD.momentum = 0.9",)), ("ASGD", ()), ("Adam", ()),
         ("AdamW", ()), ("Adagrad", ()), ("Adadelta", ()), ("Adamax", ()),
         ("RMSprop", ()), ("RMSprop", ("RMSprop.momentum = 0.9",)),
         ("Rprop", ())]
IDS = [n + ("+momentum" if b and n == "RMSprop" else "") for n, b in CASES]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    jcfg.clear_config()
    tcfg.clear_config()
    # the reference's cosine reads its length from the configuration
    monkeypatch.setattr(JO, "_query", lambda path, default=None: {
        "train.max_steps": T_MAX, "train.scheduler_interval": "step"}[path])
    yield
    jcfg.clear_config()
    tcfg.clear_config()


def bind(bindings):
    text = "".join(b + "\n" for b in bindings)
    jcfg.parse_config(text)
    tcfg.parse_config(text)


def small_model(dtype=torch.float32):
    """A small ResNet14: its parameters and their flax layout are the
    leaves (it never runs forward here)."""
    return make_resnet("ResNet14", 3, 5, planes=(4, 4, 4, 4), init_dim=4,
                       num_batches=2).to(dtype)


def close_to_largest(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def params_tree(model):
    """The parameters as the reference's params tree, in their own type
    (``convert.flax_path`` of each name; a ResNet's)."""
    tree = {}
    for name, p in model.named_parameters():
        _, *path, leaf = convert.flax_path(name)
        sub = tree
        for k in path:
            sub = sub.setdefault(k, {})
        sub[leaf] = p.detach().numpy().copy()
    return tree


class Pair:
    """One optimizer in both packages over the same leaves."""

    def __init__(self, name, weight_decay, dtype, seed=0):
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.rng = np.random.default_rng(seed)
        self.model = small_model(dtype)
        tree = convert.init_flax_variables(self.model, seed)
        convert.load_flax_variables(self.model, tree)
        self.model.to(dtype)
        self.np_dtype = np_dtype
        scheduled = name != "Rprop"
        lr = (JO.warmup_wrap(JO.cosine_annealing_lr(LR), LR, WARMUP)
              if scheduled else LR)
        self.tx = JO.get_optimizer(name, lr, weight_decay)
        self.jparams = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, np_dtype), params_tree(self.model))
        self.jstate = self.tx.init(self.jparams)
        self.opt = TO.get_optimizer(name, self.model.parameters(), LR,
                                    weight_decay)
        self.schedule = (TO.get_scheduler("CosineAnnealingLR", LR, WARMUP,
                                          max_steps=T_MAX)
                         if scheduled else None)
        self.step = 0

    def grads(self):
        return jax.tree_util.tree_map(
            lambda a: self.rng.normal(size=a.shape).astype(self.np_dtype),
            params_tree(self.model))

    def port_step(self, g):
        for n, p in self.model.named_parameters():
            p.grad = torch.as_tensor(node(g, convert.flax_path(n)[1:]))
        lr = self.schedule(self.step) if self.schedule else LR
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()

    def ref_step(self, g):
        g = jax.tree_util.tree_map(lambda a: jnp.asarray(a), g)
        upd, self.jstate = self.tx.update(g, self.jstate, self.jparams)
        self.jparams = optax.apply_updates(self.jparams, upd)

    def both(self):
        g = self.grads()
        self.port_step(g)
        self.ref_step(g)
        self.step += 1

    def check(self, tol):
        got = params_tree(self.model)
        for path, want in flat(jax.device_get(self.jparams)):
            close_to_largest(node(got, path), want, tol,
                             "/".join(path) + f" at step {self.step}")


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def x64(dtype):
    return (jax.enable_x64(True) if dtype == torch.float64
            else contextlib.nullcontext())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("decay", ["none", "coupled"])
@pytest.mark.parametrize("name,bindings", CASES, ids=IDS)
def test_optimizer_matches_optax(name, bindings, decay, dtype, tol):
    bind(bindings)
    wd = 0.0 if decay == "none" else (1e-2 if name == "AdamW" else 1e-4)
    with x64(dtype):
        pair = Pair(name, wd, dtype)
        for _ in range(STEPS):
            pair.both()
            pair.check(tol)


@pytest.mark.parametrize("name,bindings", CASES, ids=IDS)
def test_optimizer_state_crosses_packages(name, bindings):
    """Two steps in one package, the state through the other's msgpack
    bytes in the optax layout, the third step in both: equal within 1e-6
    of each leaf's largest, in both directions."""
    bind(bindings)
    wd = 1e-2 if name == "AdamW" else 1e-4
    scheduled = name != "Rprop"

    # port -> reference
    pair = Pair(name, wd, torch.float32, seed=1)
    for _ in range(2):
        pair.both()
    layout = tck.optimizer_state_to_optax(pair.model, pair.opt, pair.step,
                                          scheduled)
    raw = fser.msgpack_restore(tck.packb(layout))
    pair.jstate = fser.from_state_dict(pair.jstate, raw)
    pair.both()
    pair.check(1e-6)

    # reference -> port: a fresh port optimizer takes the reference's state
    pair = Pair(name, wd, torch.float32, seed=2)
    for _ in range(2):
        pair.both()
    raw = tck.unpackb(fser.msgpack_serialize(fser.to_state_dict(
        jax.device_get(pair.jstate))))
    pair.opt = TO.get_optimizer(name, pair.model.parameters(), LR, wd)
    state = TrainState(step=pair.step, model=pair.model,
                       optimizer=pair.opt, schedule=pair.schedule)
    tck.restore_into(state, {"opt_state": raw}, weights=False,
                     optimizer=True)
    pair.both()
    pair.check(1e-6)


def test_rprop_refuses_a_schedule():
    from nerf_downstream_tpu_torch.train.modules import ClassificationTraining

    with pytest.raises(TypeError, match="full_like"):
        JO.get_optimizer("Rprop", lambda s: 0.1).init({"w": jnp.zeros(2)})
    task = ClassificationTraining(small_model(), optimizer_name="Rprop",
                                  scheduler_name="PolyLR",
                                  scheduler_kwargs={"max_steps": 4})
    with pytest.raises(TypeError, match="constant lr"):
        task.create_state()


def test_adamw_classification_step_matches_reference(monkeypatch):
    """One ClassificationTraining step with AdamW (lr 1e-3, its weight
    decay 1e-2, no schedule) of ResNet14 at planes 8 on three scenes in
    both packages from one set of weights."""
    from tests.test_torch_port_cls import (
        FAST_XLA,
        JTask,
        JTrainState,
        models,
    )
    from nerf_downstream_tpu_torch.train.modules import ClassificationTraining

    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batch, jbatch, jmodel, model, variables = models("ResNet14")
        jtask = JTask(jmodel, optimizer_name="AdamW", scheduler_name="none",
                      lr=1e-3)
        jstate = JTrainState.create(
            jmodel.apply,
            jax.tree_util.tree_map(jnp.asarray, variables["params"]),
            jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
            jtask.make_tx())
        ref_state, ref_mets = jtask.make_train_step(donate=False).lower(
            jstate, jbatch).compile(compiler_options=FAST_XLA)(jstate, jbatch)
        ref_after = convert.flax_to_state_dict(model, {
            "params": jax.device_get(ref_state.params),
            "batch_stats": jax.device_get(ref_state.batch_stats)})

        task = ClassificationTraining(model, optimizer_name="AdamW",
                                      scheduler_name="none", lr=1e-3)
        state = task.create_state()
        assert isinstance(state.optimizer, TO.AdamW)
        tbatch = {k: torch.as_tensor(batch[k]) for k in
                  ("coordinates", "features", "mask")}
        tbatch["labels"] = torch.as_tensor(batch["labels"]).long()
        state, mets = task.train_step(state, tbatch)
    finally:
        torch.set_num_threads(n)
    np.testing.assert_allclose(float(mets["loss"]), float(ref_mets["loss"]),
                               rtol=1e-5)
    for key, v in model.state_dict().items():
        close_to_largest(v.numpy(), ref_after[key].numpy(), 1e-4, key)
