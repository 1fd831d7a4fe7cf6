"""Res16UNet50, ResNet14 and ``convert`` under the "block_resident"
conv method in the port against the JAX package, on the CPU.

- Res16UNet50 (Bottleneck blocks: 1x1 convs on resident cells) and
  ResNet14 (in-block k2 pooling, stride-2 blocks whose k3/s2 main branch
  takes the row path beside an in-block k1/s2 shortcut): eval logits
  within 1e-5 x max of the reference's.
- ``convert``: a model built under "block_resident" keeps the reference
  model's parameter tree under that method, leaf for leaf, both ways
  (the block paths use the same [K, Cin, Cout] kernels).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_port_rowpath as R  # noqa: E402
from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.models import get_model as jget_model  # noqa: E402
from nerf_downstream_tpu.sparse.types import PointField as JField  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import PointField  # noqa: E402
from test_torch_port_methods import KNOBS, routes  # noqa: E402


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


def _cloud(batches, points, channels, seed):
    coords, mask = R.cloud_batch(seed=seed, points=points)
    coords[mask] = np.floor(coords[mask])
    coords[:, 0] = np.minimum(coords[:, 0], batches - 1)
    feats = np.random.default_rng(seed + 1).normal(
        size=(coords.shape[0], channels)).astype(np.float32)
    return coords, mask, feats


@pytest.mark.parametrize("name", ["Res16UNet50", "ResNet14"])
def test_block_resident_variants_match_reference(name):
    knobs = KNOBS["block_resident"]
    batches = R.SCENES if name.startswith("Res16") else 1
    coords, mask, feats = _cloud(batches, 400, 3, 11)
    kw = (dict(planes=(4,) * 8, layers=(1,) * 8) if name.startswith("Res16")
          else dict(planes=(8,) * 4))
    jcfg.parse_config("\n".join(f"CoordinateContext.{k} = {v!r}"
                                for k, v in knobs.items()) + "\n")
    jmodel = jget_model(name=name, in_channel=3, out_channel=5,
                        num_batches=batches, **kw)
    model = get_model(name, in_channel=3, out_channel=5,
                      num_batches=batches, ctx=knobs, **kw)
    variables = convert.init_flax_variables(model, 4)
    convert.load_flax_variables(model, variables)
    jf = JField(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                mask=jnp.asarray(mask))
    tf = PointField(coords=torch.as_tensor(coords),
                    feats=torch.as_tensor(feats), mask=torch.as_tensor(mask))
    ref = np.asarray(jax.jit(lambda v, f: jmodel.apply(v, f, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), jf))
    with torch.no_grad():
        got = model.eval()(tf).numpy()
    if name.startswith("Res16"):
        ref, got = ref[mask], got[mask]
    R.close_to_largest(got, ref, 1e-5, name)
    assert "block_resident" in routes(model)


def test_convert_round_trips_a_block_resident_model():
    knobs = KNOBS["block_resident"]
    coords, mask, feats = _cloud(R.SCENES, 300, 3, 12)
    jcfg.parse_config("\n".join(f"CoordinateContext.{k} = {v!r}"
                                for k, v in knobs.items()) + "\n")
    jmodel = jget_model(name="Res16UNet14", in_channel=3, out_channel=4,
                        num_batches=R.SCENES, planes=(8,) * 8)
    jf = JField(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                mask=jnp.asarray(mask))
    tree = jax.device_get(jax.jit(lambda f: jmodel.init(
        jax.random.PRNGKey(0), f, train=False))(jf))
    model = get_model("Res16UNet14", in_channel=3, out_channel=4,
                      planes=(8,) * 8, num_batches=R.SCENES, ctx=knobs)
    convert.load_flax_variables(model, tree)
    back = convert.state_dict_to_flax(model.state_dict())
    want = jax.tree_util.tree_leaves_with_path(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]})
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
