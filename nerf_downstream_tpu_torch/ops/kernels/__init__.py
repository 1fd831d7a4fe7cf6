"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Importing this package builds nothing: a kernel is compiled on
its first launch (``build.library``).

K1 ``window_match`` (``match.py``, ``window_match.cu``) and K2
``window_gather_matmul`` (``gather_matmul.py``,
``window_gather_matmul.cu``).
"""

from nerf_downstream_tpu_torch.ops.kernels.gather_matmul import (
    window_gather_matmul,
    window_gather_matmul_plain,
)
from nerf_downstream_tpu_torch.ops.kernels.match import (
    window_match,
    window_match_plain,
)

KERNELS = (window_match, window_gather_matmul)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "window_gather_matmul",
    "window_gather_matmul_plain",
    "window_match",
    "window_match_plain",
]
