"""Synthetic PeRFception-ScanNet-like and PeRFception-CO3D-like scenes for
the presets, the tests and the smoke run: the port's
``data/plenoxel.py::make_synthetic_scene`` and ``data/utils.py::
collate_mink``, one scene as the serving benchmark builds it, the trees
the 3D training configs read (``write_scannet_tree``,
``write_co3d_tree``, ``write_scannet_ply_tree`` for the raw-mesh
``scannet_semseg.gin`` and ``write_modelnet40_tree`` for
``modelnet40_cls.gin``, over ``modelnet40_arrays``), SemanticKITTI's
LiDAR scans (``write_kitti_tree``), the frame trees the 2D configs
read (``write_perfception_2d_tree``), and the fused ensemble's scenes
with one frame each (``write_joint_tree``, ``write_co3d_frames``)."""

from __future__ import annotations

import numpy as np

from nerf_downstream_tpu_torch.data.plenoxel import make_synthetic_scene
from nerf_downstream_tpu_torch.data.utils import collate_mink

__all__ = ["collate_mink", "make_synthetic_scene", "modelnet40_arrays",
           "scene_sample", "write_co3d_tree", "write_modelnet40_tree",
           "write_kitti_tree", "write_perfception_2d_tree",
           "write_scannet_ply_tree", "write_scannet_tree"]


def scene_sample(rng, n_voxels: int, num_classes: int) -> dict:
    """One collate sample as the repo's serving benchmark builds it: a
    128^3 surface scene with its 27 SH-derived input channels."""
    sc = make_synthetic_scene(rng, n_voxels=n_voxels, reso=(128, 128, 128),
                              with_labels=True, num_classes=num_classes,
                              surface=True)
    return {
        "coordinates": sc["coords"].astype(np.float32),
        "features": np.concatenate([sc["density"], sc["sh"]], 1)[:, 1:28]
        .astype(np.float32),
        "labels": sc["labels"],
    }


def write_scannet_tree(root: str, rng, n_train: int = 3, n_val: int = 3,
                       n_voxels: int = 400, reso=(32, 32, 32),
                       scene_scale: float = 1.0,
                       num_classes: int = 41) -> str:
    """Write a synthetic PeRFception-ScanNet tree under ``root`` and return
    its data root: ``perfception-scannet/plenoxel_torch_<scene>/data.npz``
    surface shells with nyu40 labels and distances
    (``plenoxel.make_synthetic_scene``, ``plenoxel.save_npz``), and the
    sibling ``split/`` with ``scannet_256_{train,val}.txt`` and the pickled
    ``scene_scales.data`` (every scene at ``scene_scale``). Train scenes
    come first; with ``n_val = 0`` the val split lists the train scenes."""
    import os
    import pickle

    from nerf_downstream_tpu_torch.data import plenoxel

    data_root = os.path.join(root, "perfception-scannet")
    split = os.path.join(root, "split")
    os.makedirs(split, exist_ok=True)
    names = []
    for i in range(n_train + n_val):
        inst = f"scene{i:04d}_00"
        sc = make_synthetic_scene(rng, n_voxels=n_voxels, reso=reso,
                                  with_labels=True, num_classes=num_classes,
                                  surface=True)
        plenoxel.save_npz(
            os.path.join(data_root, f"plenoxel_torch_{inst}", "data.npz"),
            sc["coords"], sc["density"], sc["sh"], sc["reso"],
            labels=sc["labels"], dists=sc["dists"])
        names.append(inst)
    train, val = names[:n_train], names[n_train:] or names[:n_train]
    for phase, lst in (("train", train), ("val", val)):
        with open(os.path.join(split, f"scannet_256_{phase}.txt"), "w") as f:
            f.write("\n".join(lst))
    with open(os.path.join(split, "scene_scales.data"), "wb") as f:
        pickle.dump({n: float(scene_scale) for n in names}, f)
    return data_root


# nyu40 ids of the furniture boxes (all evaluated classes)
_BOX_IDS = (3, 4, 5, 6, 7, 8, 10, 11, 12, 14, 16, 24, 33, 34, 36, 39)


def _room(rng, n_vertices: int, extent, height: float, boxes: int,
          yaw=(0.0, 0.0)):
    """(xyz f32 [n, 3] in metres, rgb uint8 [n, 3], nyu40 label, instance)
    of one room: a floor (label 2), four walls (label 1) and ``boxes``
    furniture boxes on the floor (five faces each, an evaluated nyu40
    label and an instance id each), vertices drawn uniformly over the
    surfaces by area; one vertex in 50 is unannotated (label 0). The room
    turns about z by an angle drawn from ``yaw`` degrees, then moves to
    non-negative coordinates."""
    lx, ly = rng.uniform(*extent, 2)
    faces = [((0, 0, 0), (lx, 0, 0), (0, ly, 0), 2, 0)]  # the floor
    for o, u in (((0, 0, 0), (lx, 0, 0)), ((0, 0, 0), (0, ly, 0)),
                 ((lx, 0, 0), (0, ly, 0)), ((0, ly, 0), (lx, 0, 0))):
        faces.append((o, u, (0, 0, height), 1, 0))
    for b in range(boxes):
        sx, sy = rng.uniform(0.4, 1.4, 2)
        sz = rng.uniform(0.4, 1.2)
        x0 = rng.uniform(0.1, max(lx - sx - 0.1, 0.2))
        y0 = rng.uniform(0.1, max(ly - sy - 0.1, 0.2))
        label = int(rng.choice(_BOX_IDS))
        faces.append(((x0, y0, sz), (sx, 0, 0), (0, sy, 0), label, b + 1))
        for o, u in (((x0, y0, 0), (sx, 0, 0)), ((x0, y0, 0), (0, sy, 0)),
                     ((x0 + sx, y0, 0), (0, sy, 0)),
                     ((x0, y0 + sy, 0), (sx, 0, 0))):
            faces.append((o, u, (0, 0, sz), label, b + 1))
    o, u, v = (np.asarray([f[i] for f in faces], np.float64)
               for i in range(3))
    area = np.linalg.norm(np.cross(u, v), axis=1)
    face = rng.choice(len(faces), n_vertices, p=area / area.sum())
    a, c = rng.random((2, n_vertices, 1))
    xyz = o[face] + a * u[face] + c * v[face]
    t = np.deg2rad(rng.uniform(*yaw))
    rot = np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0],
                    [0, 0, 1]])
    xyz = xyz @ rot.T
    xyz -= xyz.min(0)
    base = rng.integers(40, 216, (len(faces), 3))
    rgb = np.clip(base[face] + rng.normal(0, 8, (n_vertices, 3)), 0, 255)
    label = np.asarray([f[3] for f in faces])[face]
    label[rng.random(n_vertices) < 0.02] = 0
    inst = np.asarray([f[4] for f in faces])[face]
    return xyz.astype(np.float32), rgb.astype(np.uint8), label, inst


def write_scannet_ply_tree(root: str, rng, n_train: int = 3, n_val: int = 2,
                           n_vertices: int = 100_000, extent=(3.0, 6.5),
                           height: float = 2.5, boxes: int = 6,
                           yaw=(0.0, 0.0)) -> str:
    """Write ScanNet-layout rooms under ``root`` and return the data root
    ``ScannetDataset`` reads: binary PLYs ``train/scene<i>_00.ply``
    (vertex x y z red green blue label instance, nyu40 labels; rooms from
    ``_room``: floor sides drawn from ``extent`` metres, so an uncropped
    room stays inside a 384-voxel grid at 2 cm when ``extent`` ends at 7.5
    or below; each turned about z by an angle from ``yaw`` degrees) and
    ``scannetv2_{train,val}.txt`` listing them. Train rooms come first;
    with ``n_val = 0`` the val list names the train rooms."""
    import os

    from nerf_downstream_tpu_torch.data.ply import write_ply

    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    names = []
    for i in range(n_train + n_val):
        name = f"train/scene{i:04d}_00.ply"
        xyz, rgb, label, inst = _room(rng, n_vertices, extent, height, boxes,
                                      yaw)
        write_ply(os.path.join(root, name), xyz, rgb, label, inst)
        names.append(name)
    train, val = names[:n_train], names[n_train:] or names[:n_train]
    for phase, lst in (("train", train), ("val", val)):
        with open(os.path.join(root, f"scannetv2_{phase}.txt"), "w") as f:
            f.write("\n".join(lst) + "\n")
    return root


def write_co3d_tree(root: str, rng, n_train: int = 4, n_val: int = 0,
                    n_voxels: int = 300, reso=(128, 128, 128),
                    num_classes: int = 3) -> tuple[str, str]:
    """Write a synthetic PeRFception-CO3D tree under ``root`` and return
    (data root, file-list directory): ``co3d/plenoxel_co3d_s<i>/data.npz``
    surface shells (``plenoxel.make_synthetic_scene``, ``surface=True``)
    and ``co3d/filelist/{train,test}.txt`` rows ``<class> s<i>``, scene i
    of class ``CLASSES[i % num_classes]``. Train scenes come first; with
    ``n_val = 0`` the test list (the val phase's) names the train
    scenes."""
    import os

    from nerf_downstream_tpu_torch.data import plenoxel
    from nerf_downstream_tpu_torch.data.co3d import CLASSES

    data_root = os.path.join(root, "co3d")
    fdir = os.path.join(data_root, "filelist")
    os.makedirs(fdir, exist_ok=True)
    lines = []
    for i in range(n_train + n_val):
        inst = f"s{i}"
        sc = make_synthetic_scene(rng, n_voxels=n_voxels, reso=reso,
                                  surface=True)
        plenoxel.save_npz(
            os.path.join(data_root, f"plenoxel_co3d_{inst}", "data.npz"),
            sc["coords"], sc["density"], sc["sh"], sc["reso"])
        lines.append(f"{CLASSES[i % num_classes]} {inst}")
    train, val = lines[:n_train], lines[n_train:] or lines[:n_train]
    for phase, lst in (("train", train), ("test", val)):
        with open(os.path.join(fdir, f"{phase}.txt"), "w") as f:
            f.write("\n".join(lst) + "\n")
    return data_root, fdir


def _smooth_frame(rng, size, cells: int = 6):
    """A smooth random RGB image of ``size`` (w, h): a cells x cells
    random grid resized bilinearly, plus a little noise."""
    from PIL import Image

    w, h = size
    grid = Image.fromarray(rng.integers(0, 256, (cells, cells, 3),
                                        dtype=np.uint8))
    arr = np.asarray(grid.resize((w, h), Image.BILINEAR), np.int16)
    arr = arr + rng.integers(-12, 13, arr.shape, dtype=np.int16)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def write_co3d_frames(frames_root: str, rng, fdir: str,
                      size=(256, 256)) -> str:
    """One smooth random JPEG frame of ``size`` (w, h) per scene that the
    file lists in ``fdir`` ({train,test}.txt) name, at
    ``<frames_root>/<class>/<inst>/fgbg/image000.jpg`` (the frames
    ``data.joint.JointCo3DDataset`` pairs with the scenes); returns
    ``frames_root``."""
    import os

    seen = set()
    for phase in ("train", "test"):
        with open(os.path.join(fdir, f"{phase}.txt")) as f:
            rows = [ln.split()[:2] for ln in f if ln.strip()]
        for cls, inst in rows:
            if (cls, inst) in seen:
                continue
            seen.add((cls, inst))
            d = os.path.join(frames_root, cls, inst, "fgbg")
            os.makedirs(d, exist_ok=True)
            _smooth_frame(rng, size).save(os.path.join(d, "image000.jpg"))
    return frames_root


def write_joint_tree(root: str, rng, frame_size=(256, 256),
                     **co3d) -> tuple[str, str, str]:
    """A synthetic PeRFception-CO3D tree (``write_co3d_tree`` with
    ``co3d``'s arguments) and one frame per scene under ``root/frames``
    (``write_co3d_frames``): (data root, file-list directory, frames
    root)."""
    import os

    data_root, fdir = write_co3d_tree(root, rng, **co3d)
    frames = write_co3d_frames(os.path.join(root, "frames"), rng, fdir,
                               frame_size)
    return data_root, fdir, frames


def write_perfception_2d_tree(root: str, rng, n_train: int = 4,
                              n_val: int = 2, n_test: int = 2,
                              frames: int = 3, size=(320, 240),
                              num_classes: int = 3) -> dict:
    """Write synthetic 2D trees under ``root`` for the ``co3d_2d``
    configs and return their paths: ``{"perfception": ..., "co3d": ...,
    "filelist": ...}``.

    - PeRFception frames: ``perfception/<class>/<scene>/fgbg/image<f>.jpg``
      (rendered object over its background), ``bg/image<f>.jpg`` (the
      background alone) and ``mask/mask<f>.jpg`` (a white ellipse on
      black), ``f`` three digits, as the readers and the background swap
      name them;
    - real-CO3D frames: ``co3d/<class>/<scene>/images/frame<f>.jpg``;
    - ``filelist/{train,val,test}.txt`` rows ``<class> <scene>
      <frames>`` over disjoint scenes, scene i of class
      ``CLASSES[i % num_classes]``, train scenes first.

    Frames are ``size`` (w, h) smooth random JPEGs from ``rng``."""
    import os

    from PIL import Image, ImageDraw

    from nerf_downstream_tpu_torch.data.co3d import CLASSES

    w, h = size
    mask = Image.new("RGB", (w, h))
    ImageDraw.Draw(mask).ellipse((w // 4, h // 4, 3 * w // 4, 3 * h // 4),
                                 fill=(255, 255, 255))
    per = os.path.join(root, "perfception")
    co3d = os.path.join(root, "co3d")
    fdir = os.path.join(root, "filelist")
    os.makedirs(fdir, exist_ok=True)
    rows = []
    for i in range(n_train + n_val + n_test):
        cls, scene = CLASSES[i % num_classes], f"sc{i}"
        dirs = {sub: os.path.join(per, cls, scene, sub)
                for sub in ("fgbg", "bg", "mask")}
        dirs["images"] = os.path.join(co3d, cls, scene, "images")
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        for f in range(frames):
            bg = _smooth_frame(rng, size)
            fg = Image.composite(_smooth_frame(rng, size), bg,
                                 mask.convert("L"))
            fg.save(os.path.join(dirs["fgbg"], f"image{f:03d}.jpg"))
            bg.save(os.path.join(dirs["bg"], f"image{f:03d}.jpg"))
            mask.save(os.path.join(dirs["mask"], f"mask{f:03d}.jpg"))
            fg.save(os.path.join(dirs["images"], f"frame{f:04d}.jpg"))
        rows.append(f"{cls} {scene} {frames}")
    splits = {"train": rows[:n_train], "val": rows[n_train:n_train + n_val],
              "test": rows[n_train + n_val:]}
    for phase, lst in splits.items():
        with open(os.path.join(fdir, f"{phase}.txt"), "w") as f:
            f.write("\n".join(lst) + "\n")
    return {"perfception": per, "co3d": co3d, "filelist": fdir}


def modelnet40_arrays(rng, n_clouds: int, n_points: int = 2048,
                      num_classes: int = 40):
    """(points f32 [n_clouds, n_points, 3], labels uint8 [n_clouds, 1]) in
    the layout of ModelNet40's HDF5 release: each cloud samples the
    surface of a box or an ellipsoid whose kind and axes follow its class,
    jittered, centred on the origin and scaled into the unit sphere."""
    labels = rng.integers(0, num_classes, n_clouds)
    data = np.empty((n_clouds, n_points, 3), np.float32)
    for i, c in enumerate(labels):
        axes = 0.3 + 0.7 * np.array([(c * 7) % 10, (c * 3) % 10 + 1,
                                     (c * 11) % 10 + 2]) / 12.0
        d = rng.normal(size=(n_points, 3))
        if c % 2:  # a box: push each direction onto its largest face
            d = d / np.abs(d).max(1, keepdims=True)
        else:  # an ellipsoid
            d = d / np.linalg.norm(d, axis=1, keepdims=True)
        p = d * axes + rng.normal(scale=0.01, size=(n_points, 3))
        p -= p.mean(0)
        data[i] = p / np.linalg.norm(p, axis=1).max()
    return data, labels.astype(np.uint8)[:, None]


def write_modelnet40_tree(root: str, rng, n_train: int = 8, n_test: int = 4,
                          n_points: int = 2048, num_classes: int = 40) -> str:
    """Write ``ply_data_train0.h5`` and ``ply_data_test0.h5`` (``data``
    f32 [N, n_points, 3], ``label`` uint8 [N, 1], as the HDF5 release
    holds them) of ``modelnet40_arrays`` clouds under ``root`` and return
    it."""
    import os

    import h5py

    os.makedirs(root, exist_ok=True)
    for phase, n in (("train", n_train), ("test", n_test)):
        data, label = modelnet40_arrays(rng, n, n_points, num_classes)
        with h5py.File(os.path.join(root, f"ply_data_{phase}0.h5"), "w") as f:
            f.create_dataset("data", data=data)
            f.create_dataset("label", data=label)
    return root


# raw SemanticKITTI ids of the synthetic street (moving classes included)
_KITTI_ROAD, _KITTI_SIDEWALK, _KITTI_BUILDING = 40, 48, 50
_KITTI_OBJECTS = (10, 252, 30, 254, 18, 258, 81)  # car, person, truck, ...


def kitti_scan(rng, beams: int = 64, azimuths: int = 2048,
               max_range: float = 80.0, boxes: int = 12):
    """One LiDAR sweep of a synthetic street, as a spinning 64-beam
    sensor (HDL-64E: elevations -24.9 to +2 degrees) 1.73 m above the
    ground sees it: every (beam, azimuth) ray returns the nearest of a
    ground plane (road within the street, sidewalk beyond), two building
    fronts along the street and one across it, and ``boxes`` boxes
    (cars, people, trucks; moving and parked), its range capped at
    ``max_range`` (an unlabeled far return). Returns (xyzi float32[beams
    * azimuths, 4], raw labels uint32 with an instance id in the upper 16
    bits)."""
    elev = np.deg2rad(np.linspace(-24.9, 2.0, beams))
    azim = np.linspace(-np.pi, np.pi, azimuths, endpoint=False)
    azim = azim + rng.uniform(0, 2 * np.pi / azimuths)
    el, az = np.meshgrid(elev, azim, indexing="ij")
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).reshape(-1, 3)
    origin = np.array([0.0, 0.0, 1.73])
    n = d.shape[0]
    t = np.full(n, max_range)
    label = np.zeros(n, np.int64)
    inst = np.zeros(n, np.int64)

    def hit(t_new, lab, ins=0):
        closer = (t_new > 0.5) & (t_new < t)
        t[closer] = t_new[closer]
        label[closer] = lab[closer] if np.ndim(lab) else lab
        inst[closer] = ins

    with np.errstate(divide="ignore", invalid="ignore"):
        tg = -origin[2] / d[:, 2]
        y_ground = origin[1] + tg * d[:, 1]
        street = rng.uniform(6.0, 9.0)
        hit(np.where(d[:, 2] < 0, tg, np.inf),
            np.where(np.abs(y_ground) < street / 2, _KITTI_ROAD,
                     _KITTI_SIDEWALK))
        for wall_y in (street / 2 + rng.uniform(3, 6),
                       -(street / 2 + rng.uniform(3, 6))):
            tw = (wall_y - origin[1]) / d[:, 1]
            hit(np.where(origin[2] + tw * d[:, 2] < rng.uniform(8, 20), tw,
                         np.inf), _KITTI_BUILDING)
        tx = (rng.uniform(40, 70) - origin[0]) / d[:, 0]
        hit(tx, _KITTI_BUILDING)
        for k in range(boxes):
            lab = int(rng.choice(_KITTI_OBJECTS))
            size = {10: (4.2, 1.8, 1.5), 252: (4.2, 1.8, 1.5),
                    30: (0.6, 0.6, 1.8), 254: (0.6, 0.6, 1.8),
                    18: (8.0, 2.5, 3.2), 258: (8.0, 2.5, 3.2),
                    81: (0.4, 0.4, 2.5)}[lab]
            c = np.array([rng.uniform(-35, 35),
                          rng.uniform(-street / 2, street / 2) * 1.4, 0.0])
            if np.abs(c[:2]).max() < 3:
                c[0] += 5.0
            lo = c - np.array([size[0] / 2, size[1] / 2, 0.0])
            hi = lo + np.array(size)
            t0 = (lo - origin) / d
            t1 = (hi - origin) / d
            near = np.nanmax(np.minimum(t0, t1), 1)
            far = np.nanmin(np.maximum(t0, t1), 1)
            hit(np.where(near <= far, near, np.inf), lab, k + 1)
    xyz = origin + t[:, None] * d
    xyz = xyz + rng.normal(scale=0.01, size=xyz.shape)
    xyzi = np.concatenate([xyz, rng.uniform(0, 1, (n, 1))], 1)
    raw = (label | (inst << 16)).astype(np.uint32)
    return xyzi.astype(np.float32), raw


def write_kitti_tree(root: str, rng, scans: dict | None = None,
                     beams: int = 64, azimuths: int = 2048) -> str:
    """Write SemanticKITTI's layout under ``root`` and return it:
    ``dataset/sequences/<seq>/velodyne/<frame>.bin`` and
    ``labels/<frame>.label`` for ``scans`` {sequence: frames} (default
    two training frames in 00 and one validation frame in 08), each from
    ``kitti_scan``; the other sequences of 00-10 are made empty, as the
    reader lists every sequence of its phase."""
    import os

    scans = scans or {"00": 2, "08": 1}
    for seq in (f"{i:02d}" for i in range(11)):
        base = os.path.join(root, "dataset", "sequences", seq)
        os.makedirs(os.path.join(base, "velodyne"), exist_ok=True)
        os.makedirs(os.path.join(base, "labels"), exist_ok=True)
        for f in range(scans.get(seq, 0)):
            xyzi, raw = kitti_scan(rng, beams, azimuths)
            xyzi.tofile(os.path.join(base, "velodyne", f"{f:06d}.bin"))
            raw.tofile(os.path.join(base, "labels", f"{f:06d}.label"))
    return root
