"""The conv methods "block_resident", "block" and "window" in the port
against the JAX package's, on the CPU.

- Res16UNet14 at planes 8 under each method: eval logits within 1e-5 x
  max of the reference's under the same method, and within 1e-4 x max of
  the port's own "auto" route (the fully-windowed path); the routes its
  convs took.

Res16UNet50, ResNet14 and ``convert`` under "block_resident" are in
``test_torch_port_methods_extra.py``, one training step under each
method in ``test_torch_port_methods_step.py``. The reference runs its
XLA path (``NDT_WINDOW_PALLAS=0``).
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_port_rowpath as R  # noqa: E402
from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.models.mink.layers import (  # noqa: E402
    SparseConv,
    SparseConvTranspose,
)
from nerf_downstream_tpu_torch.sparse.types import PointField  # noqa: E402

KNOBS = {
    "block_resident": dict(method="block_resident", grid_extent=64,
                           block_cap_divisor=1),
    "block": dict(method="block", grid_extent=64, block_cap_divisor=1),
    "window": dict(method="window", grid_extent=64),
}
AUTO = dict(grid_extent=64, window_tile=64, window_size=64,
            window_blocks=4, window_expand_factor=3)
ROUTES = {"block_resident": {"block_resident"}, "block": {"block", "row"},
          "window": {"window", "row"}}


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


def routes(model):
    return {m.route for m in model.modules()
            if isinstance(m, (SparseConv, SparseConvTranspose))
            and m.route is not None}


def port_logits(knobs, variables):
    tcfg.clear_config()
    batch = R.unet_batch()
    model = get_model("Res16UNet14", in_channel=3, out_channel=20,
                      planes=(8,) * 8, num_batches=R.SCENES, ctx=knobs,
                      assume_unique=True)
    convert.load_flax_variables(model, variables)
    field = PointField(coords=torch.as_tensor(batch["coordinates"]),
                       feats=torch.as_tensor(batch["features"]),
                       mask=torch.as_tensor(batch["mask"]))
    with torch.no_grad():
        return model.eval()(field).numpy()[batch["mask"]]


@pytest.mark.parametrize("method", sorted(KNOBS))
def test_res16unet14_eval_under_method(method):
    model = R.check_unet_eval(knobs=KNOBS[method])
    assert routes(model) == ROUTES[method]
    variables = convert.state_dict_to_flax(model.state_dict())
    ours = port_logits(KNOBS[method], variables)
    auto = port_logits(AUTO, variables)
    R.close_to_largest(ours, auto, 1e-4, f"{method} against auto")
