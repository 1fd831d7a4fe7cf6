"""Minimal PLY reader and writer (counterpart of
``nerf_downstream_tpu/data/ply.py``; the port's own copy, as it imports
nothing of the JAX package).

Reads ascii and binary_little_endian vertex elements, enough for the
ScanNet meshes (the reference loads them with plyfile,
co3d_3d/src/data/utils.py:8-22); the vertex element must come first.
``write_ply`` writes binary vertex rows with optional colours, labels and
instances.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> np.ndarray:
    """Returns a structured array of the vertex element."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)])
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("comment"):
                continue
            elif line.startswith("element"):
                _, name, count = line.split()
                cur = (name, int(count), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("__list__", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[2], _TYPES[parts[1]]))
            elif line == "end_header":
                break
        verts = None
        for name, count, props in elements:
            if name == "vertex":
                dtype = np.dtype(
                    [(p[0], p[1]) for p in props if p[0] != "__list__"]
                )
                if fmt == "ascii":
                    rows = []
                    for _ in range(count):
                        vals = f.readline().split()
                        rows.append(tuple(vals[: len(dtype.names)]))
                    verts = np.array(
                        [tuple(float(v) for v in r) for r in rows], dtype=dtype
                    )
                elif fmt == "binary_little_endian":
                    verts = np.frombuffer(
                        f.read(count * dtype.itemsize), dtype=dtype, count=count
                    )
                else:
                    raise ValueError(f"unsupported PLY format {fmt}")
                break
            else:
                # skip non-vertex element data (only works if vertex first;
                # ScanNet PLYs store vertices first)
                raise ValueError(
                    "vertex element must come first in PLY for this reader"
                )
        return verts


def load_ply(path: str, load_label: bool = False, load_instance: bool = False):
    """(xyz f32[N,3], colors f32[N,3], labels i32[N]?, instances i32[N]?) —
    mirrors the reference load_ply (utils.py:8-22)."""
    v = read_ply_vertices(path)
    xyz = np.stack(
        [v["x"], v["y"], v["z"]], axis=1
    ).astype(np.float32)
    names = v.dtype.names
    if all(c in names for c in ("red", "green", "blue")):
        colors = np.stack([v["red"], v["green"], v["blue"]], 1).astype(
            np.float32
        )
    else:
        colors = np.zeros((len(xyz), 3), np.float32)
    out = [xyz, colors]
    if load_label:
        out.append(
            v["label"].astype(np.int32)
            if "label" in names
            else np.zeros(len(xyz), np.int32)
        )
    if load_instance:
        out.append(
            v["instance"].astype(np.int32)
            if "instance" in names
            else np.zeros(len(xyz), np.int32)
        )
    return tuple(out)


def write_ply(path: str, xyz: np.ndarray, colors=None, labels=None,
              instances=None):
    """Binary little-endian PLY of ``n`` vertices: x y z (float), red
    green blue (uchar), label and instance (ushort) where given."""
    n = len(xyz)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols = [np.asarray(xyz, np.float32)]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols.append(np.asarray(colors, np.uint8))
    if labels is not None:
        props += [("label", "u2")]
        cols.append(np.asarray(labels, np.uint16)[:, None])
    if instances is not None:
        props += [("instance", "u2")]
        cols.append(np.asarray(instances, np.uint16)[:, None])
    dtype = np.dtype(props)
    arr = np.empty(n, dtype)
    i = 0
    for c in cols:
        for j in range(c.shape[1] if c.ndim > 1 else 1):
            arr[dtype.names[i]] = c[:, j] if c.ndim > 1 else c
            i += 1
    _NAMES = {"f4": "float", "u1": "uchar", "u2": "ushort"}
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {_NAMES[t]} {name}" for name, t in props]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(arr.tobytes())
