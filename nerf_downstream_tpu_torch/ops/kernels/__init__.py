"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Importing this package builds nothing: a kernel is compiled on
its first launch (``build.library``).

K1 ``window_match`` (``match.py``, ``window_match.cu``), K2
``window_gather_matmul`` (``gather_matmul.py``,
``window_gather_matmul.cu``), K3 ``window_bwd`` (``bwd.py``,
``window_bwd.cu``) and K4 ``window_dw`` (``dw.py``, ``window_dw.cu``).
"""

from nerf_downstream_tpu_torch.ops.kernels.bwd import (
    window_bwd,
    window_bwd_plain,
)
from nerf_downstream_tpu_torch.ops.kernels.dw import (
    window_dw,
    window_dw_plain,
)
from nerf_downstream_tpu_torch.ops.kernels.gather_matmul import (
    window_gather_matmul,
    window_gather_matmul_plain,
)
from nerf_downstream_tpu_torch.ops.kernels.match import (
    window_match,
    window_match_plain,
)

KERNELS = (window_match, window_gather_matmul, window_bwd, window_dw)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "window_bwd",
    "window_bwd_plain",
    "window_dw",
    "window_dw_plain",
    "window_gather_matmul",
    "window_gather_matmul_plain",
    "window_match",
    "window_match_plain",
]
