"""The port's data pipeline against the JAX package's, on the CPU: the
flagship's host transforms one by one and composed, the
PeRFception-ScanNet reader, fixed-capacity collation and the DataModule's
batch order. Each takes the same seed and the same gin bindings in both
packages and must give equal arrays (exact equality throughout)."""

import numpy as np
import pytest

from nerf_downstream_tpu import config as jcfg
from nerf_downstream_tpu.data import data_module as jdm
from nerf_downstream_tpu.data import plenoxel as jplen
from nerf_downstream_tpu.data import scannet as jscan
from nerf_downstream_tpu.data import transforms as JT
from nerf_downstream_tpu.data import utils as jutils
from nerf_downstream_tpu_torch import config as tcfg
from nerf_downstream_tpu_torch.data import data_module as tdm
from nerf_downstream_tpu_torch.data import plenoxel as tplen
from nerf_downstream_tpu_torch.data import scannet as tscan
from nerf_downstream_tpu_torch.data import transforms as TT
from nerf_downstream_tpu_torch.data import utils as tutils
from nerf_downstream_tpu_torch.data.synthetic import write_scannet_tree

FLAGSHIP = ["co3d_3d/configs/scannet_plenoxel.gin",
            "co3d_3d/configs/scannet_feature_sh.gin"]
HOST = ["RandomRotation", "RandomCrop", "RandomAffine", "CoordinateDropout",
        "RandomFeatureJitter", "RandomHorizontalFlip", "RandomTranslation",
        "ElasticDistortion"]


def parse_both(bindings=()):
    for cfg in (jcfg, tcfg):
        cfg.clear_config()
        cfg.parse_config_files_and_bindings(FLAGSHIP, list(bindings))


@pytest.fixture(autouse=True)
def _clean():
    yield
    jcfg.clear_config()
    tcfg.clear_config()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_scannet_tree(str(tmp_path_factory.mktemp("scannet")),
                              np.random.default_rng(4), n_train=5, n_val=2,
                              n_voxels=500, reso=(48, 48, 48),
                              scene_scale=0.7)


def scene(seed=0):
    rng = np.random.default_rng(seed)
    sc = tplen.make_synthetic_scene(rng, n_voxels=900, reso=(64, 64, 64),
                                    with_labels=True, num_classes=41,
                                    surface=True)
    coords = sc["coords"].astype(np.float32) * 2.5 - 60
    # the reader's raw columns: xyz, dists, density, 27 SH
    feats = np.concatenate([coords, sc["dists"][:, None].astype(np.float32),
                            sc["density"], sc["sh"]], 1)
    return coords, feats, sc["labels"]


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("name", HOST)
def test_each_flagship_transform_draws_as_the_reference(name):
    parse_both()
    c, f, lab = scene()
    for seed in (0, 1, 2):
        JT.seed(seed)
        TT.seed(seed)
        j, t = JT.TRANSFORMS[name](), TT.TRANSFORMS[name]()
        for _ in range(3):  # the global stream advances alike
            assert_same(t(c, f, lab), j(c, f, lab))


def test_host_compose_drops_the_device_transforms():
    parse_both()
    c, f, lab = scene(1)
    jc = JT.build(HOST, device_ok=True)
    tc = TT.build(HOST, device_ok=True)
    names = [type(x).__name__ for x in tc.transforms]
    assert names == [type(x).__name__ for x in jc.transforms]
    assert "ElasticDistortion" not in names
    assert "RandomFeatureJitter" not in names
    assert len(TT.build(HOST).transforms) == len(HOST)
    JT.seed(7)
    TT.seed(7)
    for _ in range(3):
        assert_same(tc(c, f, lab), jc(c, f, lab))


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("bindings", [
    (), ("PlenoxelScannetDataset.downsample_stride = 1",
         "PlenoxelScannetDataset.ignore_thres = 0.08",
         "PlenoxelScannetDataset.void_label = -1"),
])
def test_plenoxel_reader_matches_reference(tree, phase, bindings):
    parse_both((f'PlenoxelScannetDataset.data_root = "{tree}"',) + bindings)
    jds = jscan.PlenoxelScannetDataset(phase)
    tds = tscan.PlenoxelScannetDataset(phase)
    assert len(tds) == len(jds) and tds.files == jds.files
    assert tds.label_map == jds.label_map
    JT.seed(3)
    TT.seed(3)
    for i in range(len(jds)):
        a, b = tds[i], jds[i]
        assert a.keys() == b.keys()
        for k in a:
            if k == "metadata":
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_npz_round_trip_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    sc = tplen.make_synthetic_scene(rng, n_voxels=300, reso=(40, 36, 32),
                                    with_labels=True)
    for mod, name in ((tplen, "t"), (jplen, "j")):
        mod.save_npz(str(tmp_path / name / "data.npz"), sc["coords"],
                     sc["density"], sc["sh"], sc["reso"],
                     labels=sc["labels"], dists=sc["dists"])
    for path in (tmp_path / "t" / "data.npz", tmp_path / "j" / "data.npz"):
        a, b = tplen.load_npz(str(path)), jplen.load_npz(str(path))
        for k in ("coords", "density", "sh", "labels", "dists", "reso"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    keep = sc["coords"]
    for s in (1, 2, 3):
        assert_same(tplen.stride_downsample(keep, [sc["sh"]], s)[1],
                    jplen.stride_downsample(keep, [sc["sh"]], s)[1])
        assert_same(tplen.avg_downsample(keep, sc["sh"], s),
                    jplen.avg_downsample(keep, sc["sh"], s))


def samples(n=3, seed=5):
    out = []
    for i in range(n):
        c, f, lab = scene(seed + i)
        out.append({"coordinates": c[: 300 + 50 * i],
                    "features": f[: 300 + 50 * i, 5:],
                    "labels": lab[: 300 + 50 * i],
                    "dists": f[: 300 + 50 * i, 3:4],
                    "metadata": {"file": f"s{i}"}})
    return out


@pytest.mark.parametrize("capacity", [None, 2048, 4096])
def test_collate_matches_reference(capacity):
    parse_both(["CoordinateContext.grid_extent = 320"])
    s = samples()
    a = tutils.collate_mink(s, capacity=capacity, ignore_label=-255)
    b = jutils.collate_mink(s, capacity=capacity, ignore_label=-255)
    assert a.keys() == b.keys()
    for k in a:
        if k == "metadata":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tutils.next_bucket(1500) == jutils.next_bucket(1500) == 2048


def test_collate_rejects_a_span_past_the_grid_extent():
    parse_both(["CoordinateContext.grid_extent = 16"])
    for collate in (tutils.collate_mink, jutils.collate_mink):
        with pytest.raises(ValueError, match="grid_extent"):
            collate(samples(1), capacity=1024)
    # the port's explicit extent overrides the binding
    tutils.collate_mink(samples(1), capacity=1024, grid_extent=None)


@pytest.mark.parametrize("capacity", [None, 1024])
def test_data_module_batch_order_matches_reference(tree, capacity):
    """Two epochs of train batches (with the flagship's host transforms,
    one worker) and the val batches, equal to the reference's for one
    seed; at capacity 1024 the over-full batches are subsampled with the
    module's own draws."""
    parse_both([f'PlenoxelScannetDataset.data_root = "{tree}"',
                "PlenoxelScannetDataset.downsample_stride = 1"])
    JT.seed(11)
    TT.seed(11)
    kw = dict(batch_size=2, val_batch_size=2, train_num_workers=1,
              val_num_workers=1, capacity=capacity, ignore_label=-255,
              seed=3)
    jd, td = jdm.DataModule(**kw), tdm.DataModule(**kw)
    steps = 2 * (5 // 2)
    for it in ((td.train_batches(), jd.train_batches()),
               (td.val_batches("val"), jd.val_batches("val"))):
        n = 0
        for a, b in zip(*it):
            for k in ("coordinates", "features", "mask", "labels", "dists",
                      "num_points"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["metadata"] == b["metadata"]
            n += 1
            if n == steps:
                break
        assert n >= 1
