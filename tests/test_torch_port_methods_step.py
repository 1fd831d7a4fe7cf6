"""One SGD step of Res16UNet14 at planes 8 under the conv methods
"block_resident", "block" and "window" in the port against the JAX
package's under the same method, on the CPU: the loss within rtol 1e-5,
every parameter's gradient and every weight and BatchNorm statistic
after the step within 1e-4 of its leaf's largest value.

Tier 1 runs "block_resident"; "block" and "window" are under ``-m slow``
(the reference's training step compiles for about 15 s per method).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import test_torch_port_rowpath as R  # noqa: E402
from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.train.modules import (  # noqa: E402
    SegmentationTraining as JTask,
)
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.train.modules import (  # noqa: E402
    SegmentationTraining,
)
from test_torch_port_methods import KNOBS, ROUTES, routes  # noqa: E402


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


@pytest.mark.parametrize("method", [
    "block_resident",
    pytest.param("block", marks=pytest.mark.slow),
    pytest.param("window", marks=pytest.mark.slow),
])
def test_res16unet14_step_under_method(method):
    batch = R.unet_batch()
    jmodel, model, variables = R.unets(knobs=KNOBS[method])
    jcfg.parse_config("SGD.momentum = 0.9\n")
    tcfg.parse_config("SGD.momentum = 0.9\n")
    jtask = JTask(jmodel, scheduler_name="none", lr=0.1)
    stash = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    jstate = R.jstate_of(jmodel, jtask, variables,
                         optax.chain(stash, jtask.make_tx()))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rs, rm = jtask.make_train_step(donate=False).lower(jstate, jb).compile(
        compiler_options=R.FAST_XLA)(jstate, jb)
    ref_grads = convert.flax_to_state_dict(model,
                                           jax.device_get(rs.opt_state[0]))
    ref_after = convert.flax_to_state_dict(model, {
        "params": jax.device_get(rs.params),
        "batch_stats": jax.device_get(rs.batch_stats)})
    task = SegmentationTraining(model, scheduler_name="none", lr=0.1)
    state = task.create_state()
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    state, mets = task.train_step(state, tb)
    assert routes(model) == ROUTES[method]
    np.testing.assert_allclose(float(mets["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    for key, p in model.named_parameters():
        R.close_to_largest(p.grad.numpy(), ref_grads[key].numpy(), 1e-4, key)
    for key, v in model.state_dict().items():
        R.close_to_largest(v.numpy(), ref_after[key].numpy(), 1e-4, key)
