"""Build and load the port's CUDA kernels.

Each ``.cu`` source in this directory has a plain C interface and becomes
its own shared library, compiled by ``nvcc`` for ``sm_90a`` on first use
and loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds);
the ``.cuh`` headers hold device code that several sources share.
All sources compile in parallel, one ``nvcc`` process each. Libraries go
to ``nerf_downstream_tpu_torch/_build/`` (git-ignored) under a name that
hashes the source, the shared headers and the flags, so an edited source
or header is rebuilt and an unchanged one is reused. ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
SOURCES = ("window_match.cu", "window_gather_matmul.cu", "window_bwd.cu",
           "window_dw.cu", "window_gather_matmul_bs.cu",
           "row_gather_matmul.cu")
# device code the sources share (#include "..."), hashed into every name
HEADERS = ("window_gather.cuh", "window_dw.cuh", "window_gather_tc.cuh",
           "window_dw_tc.cuh")
FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            f"nvcc not found under {home}/bin or on PATH: the CUDA kernels "
            "are built on the machine with the GPU"
        )
    return found


def _target(src: str) -> tuple[str, str]:
    path = os.path.join(_HERE, src)
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for name in (src, *HEADERS):
        with open(os.path.join(_HERE, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(src)[0]
    return path, os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every source that has no up-to-date library; return
    {source stem: library path}. Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs, out = [], {}
    for src in SOURCES:
        path, lib = _target(src)
        stem = os.path.splitext(src)[0]
        out[stem] = lib
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        log = open(os.path.join(BUILD_DIR, f"{stem}.log"), "w")
        proc = subprocess.Popen(
            [nvcc, *FLAGS, "-o", tmp, path], stdout=log,
            stderr=subprocess.STDOUT,
        )
        jobs.append((proc, log, tmp, lib, stem))
    failed = []
    for proc, log, tmp, lib, stem in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            with open(log.name) as f:
                failed.append(f"{stem}: nvcc exit {rc}\n{f.read()}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``<stem>.cu``, building all kernels on the
    first call."""
    if stem not in _LIBS:
        for name, path in build_all().items():
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[stem]


def function(stem: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``<stem>.cu`` with its argument types
    declared (once), returning an int CUDA error code."""
    key = (stem, name)
    if key not in _FUNCS:
        fn = getattr(library(stem), name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _FUNCS[key] = fn
    return _FUNCS[key]


def check_inputs(dev: torch.device, specs) -> None:
    """Raise unless every ``(tensor, name, dtype, shape)`` of ``specs`` lies
    on ``dev`` with that dtype and shape, contiguous: the kernels index
    raw pointers with these strides."""
    for t, name, dtype, shape in specs:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ptxas_report() -> dict[str, str]:
    """nvcc's register/shared-memory report of the last build per source."""
    out = {}
    for src in SOURCES:
        stem = os.path.splitext(src)[0]
        log = os.path.join(BUILD_DIR, f"{stem}.log")
        if os.path.exists(log):
            with open(log) as f:
                out[stem] = f.read()
    return out
