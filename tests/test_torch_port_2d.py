"""The port's 2D classification stack against the JAX package's, on the
CPU, at small sizes (64x64 images, ResNets of one block per stage, a ViT
of width 64, depth 2 and 4 heads).

- Data (exact equality): each 2D transform, AugMix, ``BackgroundAug``,
  the four datasets and the DataModule's train order and padded, masked
  validation batches, with both packages' streams seeded alike and one
  worker.
- Models: all 9 ResNet and 6 ViT specs build with the reference's leaf
  shapes; every ResNet block type and a ViT with and without
  ``no_embed_class`` and LayerScale give the reference's logits on weights
  carried by ``convert.py``: eval mode within 1e-5 x max|logit|, train
  mode (batch statistics, the biased running variance) within the larger
  of 1e-5 and twice the reference's own spread when the same batch comes
  in another order (the batch statistics then reduce in another order;
  measured here, up to 2.4e-5 on these inputs), and the running
  statistics within 1e-5 of each one's largest entry.
- ``LitModel``: the decayed leaf set and ``_wdloss``, the schedule at
  steps 0, peak and last, one and three SGD steps (loss within 1e-5
  relative, each leaf within 1e-5 of its largest entry or twice the
  reference's own spread as above), the validation metrics.
- The torchvision/timm converter on state dicts the test builds, and
  dropout's keep rate and scaling in distribution.
"""

import glob

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_downstream_tpu import config as jcfg  # noqa: E402
from nerf_downstream_tpu.data import augmix as jaug  # noqa: E402
from nerf_downstream_tpu.data import loader2d as jld  # noqa: E402
from nerf_downstream_tpu.data import transforms2d as JT2  # noqa: E402
from nerf_downstream_tpu.models import image as jimage  # noqa: E402
from nerf_downstream_tpu.models.image import resnet2d as jres  # noqa: E402
from nerf_downstream_tpu.models.image import torch_weights as jtw  # noqa
from nerf_downstream_tpu.models.image import vit as jvit  # noqa: E402
from nerf_downstream_tpu.train import modules2d as jm2d  # noqa: E402
from nerf_downstream_tpu_torch import config as tcfg  # noqa: E402
from nerf_downstream_tpu_torch import convert  # noqa: E402
from nerf_downstream_tpu_torch.data import augmix as taug  # noqa: E402
from nerf_downstream_tpu_torch.data import loader2d as tld  # noqa: E402
from nerf_downstream_tpu_torch.data import transforms2d as TT2  # noqa
from nerf_downstream_tpu_torch.data.synthetic import (  # noqa: E402
    write_perfception_2d_tree,
)
from nerf_downstream_tpu_torch.models import image as timage  # noqa: E402
from nerf_downstream_tpu_torch.models.image import resnet2d as tres  # noqa
from nerf_downstream_tpu_torch.models.image import torch_weights as ttw  # noqa
from nerf_downstream_tpu_torch.models.image.layers import (  # noqa: E402
    init_weights,
)
from nerf_downstream_tpu_torch.models.image import vit as tvit  # noqa: E402
from nerf_downstream_tpu_torch.models.image.vit import ViT  # noqa: E402
from nerf_downstream_tpu_torch.train import modules2d as tm2d  # noqa: E402

IMAGE = convert.FlaxLayout("image")  # the 2D models' trees

SIZE = 64
# small ResNets: one block per stage, registered in both packages
BLOCKS = {
    "basic": dict(block="basic", layers=(1, 1, 1, 1)),
    "bottleneck": dict(block="bottleneck", layers=(1, 1, 1, 1)),
    "grouped": dict(block="bottleneck", layers=(1, 1, 1, 1), groups=4,
                    base_width=8),
}
VIT_SMALL = dict(dim=64, depth=2, heads=4, patch=16)
VITS = {"vit": {}, "deit3": dict(layer_scale=0.5, no_embed_class=True)}
# XLA's CPU backend at its lowest optimization level: the same arithmetic,
# compiled in about half the time
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    for name, spec in BLOCKS.items():
        for mod in (jres, tres):
            monkeypatch.setitem(mod.RESNET_SPECS, f"test_{name}", spec)
        for mod in (jimage, timage):
            monkeypatch.setattr(mod, "RESNET_LIST",
                                mod.RESNET_LIST + [f"test_{name}"])
    for name, kw in VITS.items():
        spec = dict(VIT_SMALL, **kw)
        spec.pop("patch")
        for mod in (jvit, tvit):
            monkeypatch.setitem(mod.VIT_SPECS, f"test_{name}", spec)
        for mod in (jimage, timage):
            monkeypatch.setattr(mod, "VIT_LIST",
                                mod.VIT_LIST + [f"test_{name}"])
    jcfg.clear_config()
    tcfg.clear_config()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jcfg.clear_config()
    tcfg.clear_config()


def seed_both(s: int):
    np.random.seed(s)
    for mod in (JT2, TT2, jaug, taug):
        mod.seed(s)


def rand_image(rng, w=96, h=80):
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def close_to_largest(got, want, tol, what="", floor=0.0):
    """``got`` within ``tol`` of ``want``'s largest entry (or of
    ``floor`` where that is larger)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), floor)
    assert scale > 0, what
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the largest > {tol:.3g}"


def flat(tree, prefix=(), leaf=np.asarray):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,), leaf)
        else:
            yield "/".join(prefix + (k,)), leaf(v)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("names", [
    ("RandomResizedCrop", "ColorJitter", "RandomHorizontalFlip", "ToTensor",
     "PCALoss", "Normalize"),
    ("CenterCrop", "ToTensor", "Normalize"),
    ("ColorJitter", "ToTensor"),
    ("RandomResizedCrop", "ToTensor"),
    ("RandomHorizontalFlip", "ToTensor", "PCALoss"),
    ("Resize", "ToTensor"),
])
def test_transforms_match_reference(names):
    rng = np.random.default_rng(0)
    images = [rand_image(rng) for _ in range(3)]
    outs = []
    for T in (JT2, TT2):
        seed_both(3)
        tf = T.build(list(names))
        outs.append([tf(im) for im in images])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_augmix_and_background_swap_match_reference():
    rng = np.random.default_rng(1)
    fg, bg = rand_image(rng), rand_image(rng, 120, 90)
    mask = Image.fromarray((rng.random((80, 96, 3)) > 0.5).astype(np.uint8)
                           * 255)
    outs = []
    for T, aug in ((JT2, jaug), (TT2, taug)):
        seed_both(4)
        tf = T.build(["RandomResizedCrop", "ToTensor", "Normalize"])
        mixed = [aug.augment_and_mix(fg, tf) for _ in range(3)]
        swapped = [np.asarray(T.BackgroundAug()(fg, bg, mask))
                   for _ in range(3)]
        outs.append(mixed + swapped)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames2d"))
    return write_perfception_2d_tree(root, np.random.default_rng(0),
                                     n_train=4, n_val=2, n_test=1, frames=3,
                                     size=(80, 72))


def dataset_bindings(p, bkgd=0.0):
    return [
        f'PeRFCeptionCo3DTrainDataset.data_root = "{p["perfception"]}"',
        f'PeRFCeptionCo3DTrainDataset.filelist_dir = "{p["filelist"]}"',
        f'PeRFCeptionCo3DEvalDataset.data_root = "{p["perfception"]}"',
        f'PeRFCeptionCo3DEvalDataset.filelist_dir = "{p["filelist"]}"',
        f'Co3DTrainDataset.data_root = "{p["co3d"]}"',
        f'Co3DTrainDataset.filelist_dir = "{p["filelist"]}"',
        f'Co3DEvalDataset.data_root = "{p["co3d"]}"',
        f'Co3DEvalDataset.filelist_dir = "{p["filelist"]}"',
        "PeRFCeptionCo3DTrainDataset.frames_per_scene = 3",
        f"PeRFCeptionCo3DTrainDataset.bkgd_aug = {bkgd}",
        f"RandomResizedCrop.image_size = {SIZE}",
        f"CenterCrop.image_size = {SIZE}",
    ]


def bind_both(bindings):
    for cfg in (jcfg, tcfg):
        cfg.clear_config()
        cfg.parse_config_files_and_bindings([], list(bindings))


@pytest.mark.parametrize("name,phase", [
    ("Co3DTrainDataset", None), ("Co3DEvalDataset", "val"),
    ("PeRFCeptionCo3DTrainDataset", None),
    ("PeRFCeptionCo3DEvalDataset", "test"),
])
def test_datasets_match_reference(frames, name, phase):
    bind_both(dataset_bindings(frames, bkgd=0.7))
    outs = []
    for mod in (jld, tld):
        seed_both(5)
        ds = getattr(mod, name)(*([phase] if phase else []))
        outs.append([ds[i % len(ds)] for i in range(6)])
    for a, b in zip(*outs):
        assert a["labels"] == b["labels"]
        np.testing.assert_array_equal(a["images"], b["images"])
        assert a["images"].shape == (SIZE, SIZE, 3)


def test_datamodule_batches_match_reference(frames):
    bind_both(dataset_bindings(frames, bkgd=0.5) + [
        "DataModule.train_co3d = False", "DataModule.eval_co3d = False",
        "DataModule.batch_size = 2", "DataModule.chunks = 4",
        "DataModule.num_workers = 1", "DataModule.seed = 7"])
    outs = []
    for mod in (jld, tld):
        seed_both(6)
        dm = mod.DataModule2D()
        assert dm.steps_per_epoch() == 2
        it = dm.train_batches()
        train = [next(it) for _ in range(3)]
        val = list(dm.val_batches("val"))
        outs.append((train, val))
    (jt, jv), (tt, tv) = outs
    for a, b in zip(jt + jv, tt + tv):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # 6 val frames in chunks of 4: the last batch padded, masked
    assert [len(b["labels"]) for b in tv] == [4, 4]
    np.testing.assert_array_equal(tv[1]["sample_mask"], [1, 1, 0, 0])


# -- models -------------------------------------------------------------------

def port_leaf_shapes(model) -> dict:
    """{flax path: flax shape} of a model built on the meta device."""
    out = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        if len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])
        out["/".join(convert.image_flax_path(key))] = shape
    return out


@pytest.mark.parametrize("name", list(tres.RESNET_SPECS)
                         + list(tvit.VIT_SPECS))
def test_every_spec_builds_with_the_reference_shapes(name):
    with torch.device("meta"):
        model = timage.select_model(name)
    jmodel = jimage.select_model(name)
    x = jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros(x.shape, x.dtype), train=False))
    want = {k: tuple(v.shape) for k, v in flat(shapes, leaf=lambda v: v)}
    assert port_leaf_shapes(model) == want


def randomise(model, seed):
    """Flax-distributed weights (``init_weights``), then every norm's
    scale, bias and statistics and every LayerScale drawn away from
    identity, so each does work."""
    init_weights(model, seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            leaf = key.rsplit(".", 1)[-1]
            if leaf in ("scale", "ls1", "ls2"):
                v = rng.uniform(0.5, 1.5, t.shape)
            elif leaf == "var":
                v = rng.uniform(0.5, 2.0, t.shape)
            elif leaf in ("bias", "mean"):
                v = rng.normal(size=t.shape) * 0.1
            else:
                continue
            t.copy_(torch.as_tensor(v, dtype=torch.float32))
    return model


def images(n=8, seed=0, size=SIZE):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


def ref_apply(module, tree, x, **kw):
    """The reference module's ``apply`` (``x -> output``), jitted for
    ``x``'s shape at XLA's lowest optimization level (one compile instead
    of one per eager op)."""
    fn = jax.jit(lambda v, xx: module.apply(v, xx, **kw)).lower(
        tree, jnp.asarray(x)).compile(compiler_options=FAST_XLA)
    return lambda xx: fn(tree, jnp.asarray(xx))


def reference_spread(fn, x, seed=5):
    """How far ``fn`` (batch -> per-sample outputs) moves when the same
    batch comes in another order, relative to its largest output."""
    perm = np.random.default_rng(seed).permutation(len(x))
    a, b = np.asarray(fn(x)), np.asarray(fn(x[perm]))[np.argsort(perm)]
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_resnet_blocks_match_reference(block, train):
    model = randomise(timage._ResNetBased(f"test_{block}", dropout_rate=0.0),
                      1)
    tree = convert.state_dict_to_flax(model.state_dict(), IMAGE)
    jmodel = jimage._ResNetBased(model=f"test_{block}", dropout_rate=0.0)
    x = images()
    model.train(train)
    logits = model(nchw(x)).detach().numpy()
    if not train:
        close_to_largest(logits, ref_apply(jmodel, tree, x)(x), 1e-5,
                         "eval logits")
        return
    ref = ref_apply(jmodel, tree, x, train=True, mutable=["batch_stats"])

    ref_logits, mut = ref(x)
    tol = max(1e-5, 2 * reference_spread(lambda xx: ref(xx)[0], x))
    close_to_largest(logits, ref_logits, tol, "train logits")
    stats = dict(flat(convert.state_dict_to_flax(model.state_dict(), IMAGE)[
        "batch_stats"]))
    for k, v in flat(mut["batch_stats"]):
        close_to_largest(stats[k], v, 1e-5, k)


@pytest.mark.parametrize("kind", list(VITS))
def test_vit_matches_reference(kind):
    kw = dict(VIT_SMALL, **VITS[kind])
    model = randomise(ViT(num_classes=51, image_size=SIZE, **kw), 2)
    tree = convert.state_dict_to_flax(model.state_dict(), IMAGE)
    x = images(4)
    ref = ref_apply(jvit.ViT(num_classes=51, **kw), tree, x)(x)
    close_to_largest(model(nchw(x)).detach().numpy(), ref, 1e-5, "logits")
    # the port's tree has exactly the reference's leaves
    jv = jax.eval_shape(lambda: jvit.ViT(num_classes=51, **kw).init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    assert {k: v.shape for k, v in flat(jv["params"], leaf=lambda v: v)} \
        == {k: v.shape for k, v in flat(tree["params"])}


def test_bf16_compute_types():
    """Under bf16 the convs and blocks compute in bf16, the pooled
    features and the heads in f32, as the reference's ``dtype`` binds."""
    res = timage._ResNetBased("test_basic", dtype=torch.bfloat16).eval()
    vit = ViT(num_classes=51, image_size=SIZE, dtype=torch.bfloat16,
              **VIT_SMALL).eval()
    x = nchw(images(2))
    assert res.model(x).dtype == torch.float32
    assert res(x).dtype == vit(x).dtype == torch.float32
    assert res.model.layer1_0(
        torch.zeros(1, 64, 8, 8, dtype=torch.bfloat16)).dtype == torch.bfloat16
    assert vit.blocks[0].attn(torch.zeros(1, 5, 64)).dtype == torch.bfloat16


def test_dropout_keep_rate_and_scaling():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = timage.dropout(x, 0.2, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.8, rtol=1e-7)
    # the reference's, in distribution
    jy = jax.random.bernoulli(jax.random.PRNGKey(0), 0.8, (200_000,))
    assert abs(float(kept.float().mean()) - float(jy.mean())) < 0.005


@pytest.mark.parametrize("name", ["test_grouped", "test_deit3"])
def test_fresh_init_follows_the_reference_distributions(name):
    """``init_weights`` against the reference's own init of the same model:
    every constant leaf equal (biases, BatchNorm and LayerNorm at identity,
    a residual branch's last BatchNorm scale 0, LayerScale), every random
    leaf (lecun-normal kernels, ``cls_token`` and ``pos_embed`` at 0.02)
    with the reference's mean and standard deviation within four times
    the sampling spread of a leaf of its size (at least 5 %)."""
    tcfg.parse_config(f"ViTBased.image_size = {SIZE}\n")
    model = init_weights(timage.select_model(name), 7)
    got = dict(flat(convert.state_dict_to_flax(model.state_dict(), IMAGE)))
    jmodel = jimage.select_model(name)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    ref = dict(flat(jax.jit(lambda k: jmodel.init(k, x)).lower(
        jax.random.PRNGKey(7)).compile(compiler_options=FAST_XLA)(
        jax.random.PRNGKey(7))))
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        if np.all(r == r.flat[0]):
            np.testing.assert_array_equal(g, r, err_msg=k)
            continue
        # two sample deviations of n entries differ by about 1/sqrt(n)
        # of either: allow four times that, at least 5 %
        sd, tol = float(r.std()), max(0.05, 4 / np.sqrt(r.size))
        assert abs(float(g.mean())) < tol * sd, k
        np.testing.assert_allclose(float(g.std()), sd, rtol=tol, err_msg=k)


# -- LitModel ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["test_grouped", "test_deit3"])
def test_decayed_leaves_match_reference(name):
    task = tm2d.LitModel(model_name=name)
    jtask = jm2d.LitModel(model_name=name)
    randomise(task.model, 3)
    tree = convert.state_dict_to_flax(task.model.state_dict(), IMAGE)
    seen = []
    jnorm = jnp.linalg.norm

    def spy(p):
        seen.append(np.asarray(p))
        return jnorm(p)

    jnp.linalg.norm = spy
    try:
        ref = float(jtask._wdloss(tree["params"]))
    finally:
        jnp.linalg.norm = jnorm
    decayed = tm2d.decayed_kernels(task.model)
    params = dict(task.model.named_parameters())
    assert len(decayed) == len(seen)
    got = sorted(float(np.linalg.norm(params[n].detach().numpy()))
                 for n in decayed)
    np.testing.assert_allclose(
        got, sorted(float(np.linalg.norm(s)) for s in seen), rtol=1e-6)
    np.testing.assert_allclose(float(task._wdloss(task.model)), ref,
                               rtol=1e-5)
    if "deit3" in name:
        assert sorted(d.split(".", 2)[2] for d in decayed) == \
            sorted(["mlp.fc1.kernel", "mlp.fc2.kernel"] * VIT_SMALL["depth"])
    else:
        assert all("conv" in d or d == "fc.kernel" for d in decayed)
        assert "fc.kernel" in decayed


def test_schedule_matches_reference():
    for total in (10, 97, 10_000):
        peak = max(int(total * 0.1), 1)
        j, t = (jm2d.warmup_quarter_cosine(0.1, total),
                tm2d.warmup_quarter_cosine(0.1, total))
        for step in (0, 1, peak, peak + 1, total // 2, total - 1, total):
            # XLA's f32 cos and the port's differ by an ulp of the
            # argument near pi/2
            np.testing.assert_allclose(t(step), float(j(step)), rtol=0,
                                       atol=1e-6 * 0.1)
        assert t(0) == 0.0 and t(peak) == pytest.approx(0.1)


def jax_state(jtask, tree):
    """The reference's training state over ``tree`` (fresh optimizer)."""
    from nerf_downstream_tpu.train.state import TrainState

    return TrainState.create(
        jtask.model.apply, jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        jax.tree_util.tree_map(jnp.asarray, tree.get("batch_stats", {})),
        jtask.make_tx())


@pytest.mark.parametrize("name,steps", [("test_basic", 1),
                                        ("test_deit3", 3)])
def test_litmodel_steps_match_reference(name, steps):
    """SGD steps (lr 0, 0.05 and 0.1 under the warmup of 20 steps;
    momentum 0.9) on batches of four 32x32 frames in both packages from
    one start, the models computing in f64 (the loss and the heads stay
    f32, as the reference casts them): after each step the loss, and every
    parameter, running statistic and momentum trace (the step's gradient
    enters it) within 1e-5 of its largest entry. One step of the ResNet
    (XLA's CPU convolutions in f64 are slow; its first update has lr 0, so
    the trace holds the gradient), three of the ViT.

    Why f64: in f32 a ReLU gate within rounding of zero flips between any
    two orders of summation (one flip moves a small layer's gradient by a
    percent, in the reference against itself too), so f32 runs of steps
    drift apart by chance; in f64 they do not, and the step's arithmetic
    is held exactly. A ViT's key bias has no gradient in exact arithmetic
    (the softmax drops a constant per query), so each trace leaf is also
    held to 1e-5 of 1e-6 of the largest trace entry."""
    jcfg.parse_config("ResNetBased.dropout_rate = 0.0\n")
    tcfg.parse_config("ResNetBased.dropout_rate = 0.0\n"
                      "ViTBased.image_size = 32\n")
    for cfg, f64 in ((jcfg, jnp.float64), (tcfg, torch.float64)):
        cfg.bind("ResNetBased", "dtype", f64)
        cfg.bind("ViTBased", "dtype", f64)
    rng = np.random.default_rng(1)
    batches = [{"images": images(4, seed=10 + i, size=32),
                "labels": rng.integers(0, 51, 4).astype(np.int32)}
               for i in range(steps)]
    task = tm2d.LitModel(model_name=name, num_training_steps=20)
    randomise(task.model, 4)
    tree = convert.state_dict_to_flax(task.model.state_dict(), IMAGE)
    task.model.double()
    state = task.create_state()
    with jax.enable_x64(True):
        jtask = jm2d.LitModel(model_name=name, num_training_steps=20)
        tree64 = jax.tree_util.tree_map(
            lambda v: np.asarray(v, np.float64), tree)
        jstate = jax_state(jtask, tree64)
        jbatches = [{"images": jnp.asarray(b["images"], jnp.float64),
                     "labels": jnp.asarray(b["labels"])} for b in batches]
        key = jax.random.PRNGKey(0)
        jstep = jax.jit(jtask._train_step_body).lower(
            jstate, jbatches[0], key).compile(compiler_options=FAST_XLA)
        for i, (b, jb) in enumerate(zip(batches, jbatches)):
            jstate, ref_mets = jstep(jstate, jb, key)
            state, mets = task.train_step(state, {
                "images": torch.as_tensor(b["images"], dtype=torch.float64),
                "labels": torch.as_tensor(b["labels"]).long()})
            assert state.step == int(jstate.step) == i + 1
            for k in ("loss", "wdloss", "acc"):
                np.testing.assert_allclose(float(mets[k]),
                                           float(ref_mets[k]), rtol=1e-5,
                                           err_msg=k)
            ref = dict(flat({
                "params": jax.device_get(jstate.params),
                "batch_stats": jax.device_get(jstate.batch_stats),
                "trace": jax.device_get(jstate.opt_state[0].trace)}))
            bufs = {n: state.optimizer.state[p]["momentum_buffer"]
                    for n, p in task.model.named_parameters()}
            got = dict(flat(convert.state_dict_to_flax(
                task.model.state_dict(), IMAGE)))
            got.update(("trace/" + k, v) for k, v in flat(
                convert.state_dict_to_flax(bufs, IMAGE)["params"]))
            assert set(got) == set(ref)
            largest = max(float(np.abs(v).max()) for k, v in ref.items()
                          if k.startswith("trace/"))
            for k in ref:
                close_to_largest(got[k], ref[k], 1e-5, f"step {i}: {k}",
                                 floor=1e-6 * largest
                                 if k.startswith("trace/") else 0.0)


@pytest.mark.parametrize("name", ["test_basic", "test_deit3"])
def test_training_state_checkpoints_cross_packages(name, tmp_path):
    """A training state after one step (momentum trace non-zero) written
    by each package restores into the other bit for bit: weights, running
    statistics, momentum trace and step."""
    from nerf_downstream_tpu.train import checkpoints as jck
    from nerf_downstream_tpu_torch.train import checkpoints as tck

    tcfg.parse_config(f"ViTBased.image_size = {SIZE}\n")
    task = tm2d.LitModel(model_name=name, num_training_steps=20)
    jtask = jm2d.LitModel(model_name=name, num_training_steps=20)
    randomise(task.model, 5)
    state = task.create_state()
    state, _ = task.train_step(state, {
        "images": torch.as_tensor(images(2)),
        "labels": torch.tensor([3, 7])})
    bufs = {n: state.optimizer.state[p]["momentum_buffer"]
            for n, p in task.model.named_parameters()}
    want = dict(flat(convert.state_dict_to_flax(task.model.state_dict(),
                                                IMAGE)))
    want.update(("trace/" + k, v) for k, v in flat(
        convert.state_dict_to_flax(bufs, IMAGE)["params"]))

    # port -> reference
    tck.save_training_state(str(tmp_path / "port.ckpt"), state)
    blank = jax_state(jtask, convert.state_dict_to_flax(
        init_weights(timage.select_model(name), 0).state_dict(), IMAGE))
    raw = jck.load_checkpoint(str(tmp_path / "port.ckpt"))
    js = jck.restore_into(blank, raw, weights=True, optimizer=True)
    got = dict(flat({"params": jax.device_get(js.params),
                     "batch_stats": jax.device_get(js.batch_stats),
                     "trace": jax.device_get(js.opt_state[0].trace)}))
    assert raw["global_step"] == 1 and got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # reference -> port
    jck.save_checkpoint(str(tmp_path / "jax.ckpt"), js.replace(step=1))
    fresh = tm2d.LitModel(model_name=name, num_training_steps=20)
    init_weights(fresh.model, 0)
    st = fresh.create_state()
    raw = tck.load_checkpoint(str(tmp_path / "jax.ckpt"))
    tck.restore_into(st, raw, weights=True, optimizer=True)
    bufs = {n: st.optimizer.state[p]["momentum_buffer"]
            for n, p in fresh.model.named_parameters()}
    got = dict(flat(convert.state_dict_to_flax(fresh.model.state_dict(),
                                               IMAGE)))
    got.update(("trace/" + k, v) for k, v in flat(
        convert.state_dict_to_flax(bufs, IMAGE)["params"]))
    assert raw["global_step"] == 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_validation_metrics_match_reference():
    task = tm2d.LitModel(model_name="test_basic")
    jtask = jm2d.LitModel(model_name="test_basic")
    rng = np.random.default_rng(2)
    batches = [{"labels": rng.integers(0, 51, 4).astype(np.int32),
                "sample_mask": np.array([1, 1, 1, i == 0], bool)}
               for i in range(2)]
    logits = [rng.normal(size=(4, 51)).astype(np.float32) for _ in range(2)]
    for b in batches:
        b["labels"][0] = 3
    logits[0][0, 3] = 9.0
    out = []
    for t, conv in ((jtask, jnp.asarray), (task, torch.as_tensor)):
        t.on_validation_start()
        results = []
        for b, lg in zip(batches, logits):
            t.validation_batch_end(conv(lg), {k: conv(v)
                                              for k, v in b.items()})
            loss = t._celoss(conv(lg), conv(b["labels"]),
                             conv(b["sample_mask"]))
            results.append({"loss": float(loss)})
        out.append(t.validation_epoch_end(results, None))
    assert out[0]["val/acc"] == out[1]["val/acc"] > 0
    np.testing.assert_allclose(out[1]["val/loss"], out[0]["val/loss"],
                               rtol=1e-6)


# -- pretrained weights ------------------------------------------------------

def torchvision_state_dict(spec, rng):
    """A torchvision-style ResNet ``state_dict`` of ``spec`` (random)."""
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = rng.normal(size=(cout, cin, k, k))

    def bn(name, c):
        for leaf, v in (("weight", rng.uniform(0.5, 1.5, c)),
                        ("bias", rng.normal(size=c)),
                        ("running_mean", rng.normal(size=c)),
                        ("running_var", rng.uniform(0.5, 2, c))):
            sd[f"{name}.{leaf}"] = v
        sd[f"{name}.num_batches_tracked"] = np.array(1)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    g, bw = spec.get("groups", 1), spec.get("base_width", 64)
    for s, (p, n) in enumerate(zip((64, 128, 256, 512), spec["layers"])):
        for i in range(n):
            src = f"layer{s + 1}.{i}"
            if spec["block"] == "basic":
                out = p
                conv(f"{src}.conv1", p, cin, 3)
                conv(f"{src}.conv2", p, p, 3)
                norms = [(f"{src}.bn1", p), (f"{src}.bn2", p)]
            else:
                w, out = int(p * bw / 64) * g, 4 * p
                conv(f"{src}.conv1", w, cin, 1)
                conv(f"{src}.conv2", w, w // g, 3)
                conv(f"{src}.conv3", out, w, 1)
                norms = [(f"{src}.bn1", w), (f"{src}.bn2", w),
                         (f"{src}.bn3", out)]
            for nm, c in norms:
                bn(nm, c)
            if cin != out or (s > 0 and i == 0):
                conv(f"{src}.downsample.0", out, cin, 1)
                bn(f"{src}.downsample.1", out)
            cin = out
    sd["fc.weight"] = rng.normal(size=(1000, cin))
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}


def timm_state_dict(dim, depth, layer_scale, rng, tokens):
    sd = {"patch_embed.proj.weight": rng.normal(size=(dim, 3, 16, 16)),
          "patch_embed.proj.bias": rng.normal(size=dim),
          "cls_token": rng.normal(size=(1, 1, dim)),
          "pos_embed": rng.normal(size=(1, tokens, dim)),
          "norm.weight": rng.normal(size=dim),
          "norm.bias": rng.normal(size=dim),
          "head.weight": rng.normal(size=(1000, dim))}
    for i in range(depth):
        b = f"blocks.{i}"
        sd.update({
            f"{b}.norm1.weight": rng.normal(size=dim),
            f"{b}.norm1.bias": rng.normal(size=dim),
            f"{b}.attn.qkv.weight": rng.normal(size=(3 * dim, dim)),
            f"{b}.attn.qkv.bias": rng.normal(size=3 * dim),
            f"{b}.attn.proj.weight": rng.normal(size=(dim, dim)),
            f"{b}.attn.proj.bias": rng.normal(size=dim),
            f"{b}.norm2.weight": rng.normal(size=dim),
            f"{b}.norm2.bias": rng.normal(size=dim),
            f"{b}.mlp.fc1.weight": rng.normal(size=(4 * dim, dim)),
            f"{b}.mlp.fc1.bias": rng.normal(size=4 * dim),
            f"{b}.mlp.fc2.weight": rng.normal(size=(dim, 4 * dim)),
            f"{b}.mlp.fc2.bias": rng.normal(size=dim),
        })
        if layer_scale:
            sd[f"{b}.ls1.gamma"] = rng.normal(size=dim)
            sd[f"{b}.ls2.gamma"] = rng.normal(size=dim)
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}


@pytest.mark.parametrize("arch", ["test_grouped", "test_deit3"])
def test_pretrained_converter_matches_reference(arch, tmp_path, monkeypatch):
    monkeypatch.setenv("NDT_PRETRAINED_DIR", str(tmp_path))
    rng = np.random.default_rng(0)
    if arch.startswith("test_deit3"):
        spec = tvit.VIT_SPECS[arch]
        sd = timm_state_dict(spec["dim"], spec["depth"], True, rng,
                             (SIZE // 16) ** 2)
        ref = jtw.convert_timm_vit(sd, arch), {}
        got = ttw.convert_timm_vit(sd, arch), {}
        model = ViT(num_classes=51, image_size=SIZE, pretrained=True,
                    pretrained_arch=arch, **dict(VIT_SMALL, **VITS["deit3"]))
    else:
        sd = torchvision_state_dict(BLOCKS["grouped"], rng)
        ref = jtw.convert_torchvision_resnet(sd, arch)
        got = ttw.convert_torchvision_resnet(sd, arch)
        model = timage._ResNetBased(arch, pretrained=True)
    for a, b in zip(ref, got):
        fa, fb = dict(flat(a)), dict(flat(b))
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    # the reference's store, read by the port into its model
    jtw.save_converted(arch, *ref)
    init_weights(model, 0)
    head = {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith(("fc.", "head."))}
    ttw.apply_pretrained(model, arch, model.pretrained_submodule)
    tree = convert.state_dict_to_flax(model.state_dict(), IMAGE)
    sub = "model" if arch == "test_grouped" else None
    for coll, src in zip(("params", "batch_stats"), ref):
        dst = tree[coll][sub] if sub else tree.get(coll, {})
        for k, v in flat(src):
            np.testing.assert_array_equal(dict(flat(dst))[k], v)
    for k, v in head.items():  # the head stays fresh
        assert torch.equal(model.state_dict()[k], v)


def test_all_2d_configs_parse_and_bind():
    files = sorted(glob.glob("co3d_2d/configs/**/*.gin", recursive=True))
    assert len(files) == 96
    import nerf_downstream_tpu_torch.co3d_2d.train  # noqa: F401 (registers)

    for path in files:
        jcfg.clear_config()
        tcfg.clear_config()
        jcfg.parse_config_files_and_bindings([path], [])
        tcfg.parse_config_files_and_bindings([path], [])
        assert tcfg.config_str() == jcfg.config_str(), path
        tcfg.check_bindings()
        name = tcfg.query_parameter("LitModel.model_name")
        assert name in timage.RESNET_LIST + timage.VIT_LIST, path
