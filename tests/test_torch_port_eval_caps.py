"""The ``eval_64k`` window knobs against a batch that overflows them, in the
PyTorch port and the JAX package.

A stride-2 down conv's plan is cross-set: it has no escape list, so its
coverage (``window_expand_factor x window_blocks x window_size`` = 1,536
table rows for tiles of 128 coarse rows) is a hard bound, and a span past
it NaN-poisons the conv (fail loud). The fifth synthetic ``eval_64k``
batch of seed 0 (the batches ``eval3d --seed 0`` draws) has one such tile
in its first down conv. The port must count it exactly as the reference
does and poison the batch, never compute on a truncated window.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu.ops import window_conv as jwc  # noqa: E402
from nerf_downstream_tpu_torch import convert, serve  # noqa: E402
from nerf_downstream_tpu_torch.models import get_model  # noqa: E402
from nerf_downstream_tpu_torch.ops import window_conv as twc  # noqa: E402

OVERFLOWING_REQUEST = 4  # of seed 0


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_eval64k_down_conv_overflow_poisons_as_reference(monkeypatch):
    rng = np.random.default_rng(0)
    for _ in range(OVERFLOWING_REQUEST + 1):
        batch = serve.make_batch("eval_64k", rng)
    p = serve.PRESETS["eval_64k"]
    ctx = dict(p["ctx"], grid_extent=p["grid_extent"],
               num_batches=p["scenes"])
    net = get_model("Res16UNet14", in_channel=serve.IN_CHANNELS,
                    out_channel=serve.NUM_CLASSES, ctx=ctx,
                    assume_unique=True, planes=(8,) * 8)
    convert.load_flax_variables(net, convert.init_flax_variables(net, 0))
    net.eval()

    cross = []  # (table coords, table mask, kwargs, port n_escaped)
    build = twc.build_plan_direct

    def recording(coords, mask, offsets, **kw):
        plan = build(coords, mask, offsets, **kw)
        if kw.get("out_coords") is not None and not kw.get("transpose"):
            cross.append((coords, mask, offsets, kw, int(plan.n_escaped)))
        return plan

    monkeypatch.setattr(twc, "build_plan_direct", recording)
    logits, mets = serve.eval_step(net, batch)

    # the four down convs, finest first; only the first overflows
    assert [c[4] for c in cross] == [1, 0, 0, 0]
    coords, mask, offsets, kw, _ = cross[0]
    assert int(mask.sum()) == 62400
    assert kw["tile"] == 128 and kw["blocks"] * kw["window"] == 1536
    jkw = dict(kw, out_coords=jnp.asarray(kw["out_coords"].numpy()),
               out_mask=jnp.asarray(kw["out_mask"].numpy()))
    jplan = jwc.build_plan_direct(jnp.asarray(coords.numpy()),
                                  jnp.asarray(mask.numpy()), offsets, **jkw)
    assert int(jplan.n_escaped) == 1
    valid = torch.as_tensor(batch["mask"])
    assert torch.isnan(logits[valid]).all()
    assert not np.isfinite(float(mets["loss"]))
