"""PyTorch / CUDA port of the sparse-voxel segmentation stack.

The JAX package ``nerf_downstream_tpu`` is the reference; this package
mirrors its layout (``sparse/``, ``ops/``, ``ops/kernels/``,
``models/mink/``, ``train/``) so every module has a counterpart there.
Its main paths are Res16UNet inference (``serve.py``) and its training
step (``train3d.py``) over windowed sparse convolutions; the four
hand-written CUDA kernels on those paths live in ``ops/kernels/``.

Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU; nothing falls back to the CPU on its own.
"""

from nerf_downstream_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
