"""The port's Res16UNet in the weight-sparse eval modes against the JAX
package's, on the CPU.

A small Res16UNet14 (planes of 8, 1024 rows, two scenes) in sparse mode 2
(ZAXIS), in mode 1 over pruned offsets (padded and symmetric subsets of
the 3x3x3 kernels, 4 of 8 offsets of the down convs, block8 unpruned) and
in mode 1 over pruned 4x4 weight blocks (half of every offset's blocks)
must give the reference model's logits on the same variables and maps
within rtol = atol = 1e-4 in f32, every logit finite, with the convs
routed as the reference routes them: down convs over a subset to the row
path (kernel map and K6), block-pruned windowed convs to K5, transpose
convs dense. The pruned-eval maps come from ``eval3d.derive_maps`` and
must equal the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu import config as cfg  # noqa: E402
from nerf_downstream_tpu.models import get_model as jax_get_model  # noqa: E402
from nerf_downstream_tpu.sparse.types import PointField as JField  # noqa: E402
from nerf_downstream_tpu.utils import prune as jprune  # noqa: E402
from nerf_downstream_tpu_torch import convert, eval3d  # noqa: E402
from nerf_downstream_tpu_torch.data import synthetic  # noqa: E402
from nerf_downstream_tpu_torch.sparse.types import PointField  # noqa: E402
from nerf_downstream_tpu_torch.utils import prune as tprune  # noqa: E402

CLASSES = 20
# tight windows with escape lists at every level (symmetric sets only)
TIGHT = dict(method="hybrid", level_caps=(1024, 512, 256, 128, 64),
             window_tile=64,
             window_size=32, window_blocks=2, window_expand_factor=3,
             window_escape_cap=(8192, 2048, 256, 0, 0),
             window_escape_tiles=(144, 72, 36, 2, 2))
# windows wide enough that no entry escapes: padded subsets have no
# escape list
WIDE = dict(TIGHT, window_size=256, window_blocks=4, window_escape_cap=None)
PADDED = (0, 1, 4, 13, 14, 22, 26)  # (dx, dy) groups of 1, 1, 3, 1, 1
UNIFORM = (0, 4, 8, 9, 13, 17, 18, 22, 26)  # three groups of 3, symmetric


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    cfg.clear_config()
    monkeypatch.setenv("NDT_WINDOW_PALLAS", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    cfg.clear_config()


def model_batch(seed=0, scenes=2, voxels=440):
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
    return synthetic.collate_mink(samples, capacity=1024)


def prune_model_tree(params, case, rng):
    """The variable tree pruned for one case: whole offsets (mode 1 over
    offsets; k3 kernels of the first four stages to the padded set, the
    rest but block8 to the symmetric uniform set, down convs to 4 of 8)
    or whole 4x4 blocks (half of each offset's, never all of them)."""
    flat = tprune.flatten(params)
    for path, arr in flat.items():
        if path[-1] != "kernel" or arr.shape[0] == 1 or "convtr" in path[0]:
            continue
        out = np.zeros_like(arr)
        if case == "offsets":
            if arr.shape[0] == 8:
                keep = (0, 3, 4, 7)
            elif path[0].startswith("block8"):
                continue
            elif path[0][:6] in ("block1", "block2", "block3", "block4"):
                keep = PADDED
            else:
                keep = UNIFORM
            out[list(keep)] = arr[list(keep)]
        else:
            nbi, nbo = -(-arr.shape[1] // 4), -(-arr.shape[2] // 4)
            for k in range(arr.shape[0]):
                pick = rng.permutation(nbi * nbo)[: nbi * nbo // 2]
                out[k] = arr[k]
                for p in pick:
                    bi, bo = divmod(int(p), nbo)
                    out[k, bi * 4:(bi + 1) * 4, bo * 4:(bo + 1) * 4] = 0
        flat[path] = out
    return tprune.unflatten(flat)


@pytest.mark.parametrize("case,mode,knobs,routes", [
    ("zaxis", 2, TIGHT, {"row": 4, "windowed": 22}),
    ("offsets", 1, WIDE, {"row": 4, "windowed": 22}),
    ("blocks", 1, TIGHT, {"blocksparse": 22, "windowed": 4}),
])
def test_sparse_model_matches_reference(monkeypatch, case, mode, knobs,
                                        routes):
    batch = model_batch()
    model_kw = dict(planes=(8,) * 8)
    dense = eval3d.get_model("Res16UNet14", in_channel=27,
                             out_channel=CLASSES, **model_kw)
    variables = convert.init_flax_variables(dense, 5)
    if case != "zaxis":
        variables["params"] = prune_model_tree(
            variables["params"], case, np.random.default_rng(1))
    layout = "csr" if case == "blocks" else "strided"
    vmap, bmap = eval3d.derive_maps(variables["params"], [mode] * 9, layout,
                                    granularity=4)
    if case == "offsets":
        assert vmap is not None and bmap is None
        assert "block8_0/conv1" not in vmap and len(vmap) == 20
    if case == "blocks":
        assert vmap is None and bmap is not None
    # the reference's maps from its own helpers
    ref_vmap = jprune.pruned_offsets_map(variables["params"]) or None
    assert vmap == (ref_vmap if mode == 1 else None)

    lines = ['CoordinateContext.method = "hybrid"',
             "CoordinateContext.grid_extent = 64",
             "field_to_sparse.assume_unique = True"]
    lines += [f"CoordinateContext.{k} = {v!r}" for k, v in knobs.items()]
    cfg.parse_config("\n".join(lines) + "\n")
    if vmap:
        cfg.bind("CoordinateContext", "valid_offsets_map", vmap)
    if bmap:
        cfg.bind("CoordinateContext", "block_live_map", bmap)
        cfg.bind("CoordinateContext", "block_live_granularity", 4)
    jmodel = jax_get_model(name="Res16UNet14", out_channel=CLASSES,
                           num_batches=2, sparse=[mode] * 9, **model_kw)
    jfield = JField(coords=jnp.asarray(batch["coordinates"]),
                    feats=jnp.asarray(batch["features"]),
                    mask=jnp.asarray(batch["mask"]))
    ref = np.asarray(jax.jit(lambda v, f: jmodel.apply(v, f, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), jfield))

    monkeypatch.setitem(eval3d.serve.PRESETS, "tiny", dict(
        scenes=2, capacity=1024, grid_extent=64, assume_unique=True,
        ctx=knobs))
    model = eval3d.build_evaluator(
        "tiny", variables, sparse_mode=[mode] * 9, valid_offsets_map=vmap,
        block_live_map=bmap, block_live_granularity=4, device="cpu",
        compute_dtype=torch.float32, model="Res16UNet14", **model_kw)
    field = PointField(coords=torch.as_tensor(batch["coordinates"]),
                       feats=torch.as_tensor(batch["features"]),
                       mask=torch.as_tensor(batch["mask"]))
    with torch.inference_mode():
        logits = model(field)
    assert eval3d.route_counts(model) == routes
    m = batch["mask"]
    assert np.isfinite(ref[m]).all() and torch.isfinite(logits[m]).all()
    np.testing.assert_allclose(logits.numpy()[m], ref[m], rtol=1e-4,
                               atol=1e-4)
