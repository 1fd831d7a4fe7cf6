"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Importing this package builds nothing: a kernel is compiled on
its first launch (``build.library``).

K1 ``window_match`` and its window-starts pass ``window_starts``
(``match.py``, ``window_match.cu``), K2
``window_gather_matmul`` (``gather_matmul.py``,
``window_gather_matmul.cu``), K3 ``window_bwd`` (``bwd.py``,
``window_bwd.cu``), K4 ``window_dw`` (``dw.py``, ``window_dw.cu``), K5
``window_gather_matmul_bs`` (``gather_matmul_bs.py``,
``window_gather_matmul_bs.cu``) and K6 ``row_gather_matmul``
(``row_gather.py``, ``row_gather_matmul.cu``). K2, K3, K4 and K5 run
bfloat16 inputs on the tensor cores (``window_gather_tc.cuh``, K5 with a
liveness policy; ``window_dw_tc.cuh``; launch choices in ``tc.py``) and
float32 inputs on the CUDA cores; so does K6 (``row_gather.py``, its
split in ``tc.row_choice``); K1 and the pass run on the CUDA cores.
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
from nerf_downstream_tpu_torch.ops.kernels.gather_matmul_bs import (
    window_gather_matmul_bs,
    window_gather_matmul_bs_plain,
)
from nerf_downstream_tpu_torch.ops.kernels.match import (
    window_match,
    window_match_plain,
    window_starts,
    window_starts_plain,
)
from nerf_downstream_tpu_torch.ops.kernels.row_gather import (
    row_gather_matmul,
    row_gather_matmul_plain,
)

KERNELS = (window_starts, window_match, window_gather_matmul, window_bwd,
           window_dw, window_gather_matmul_bs, row_gather_matmul)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "row_gather_matmul",
    "row_gather_matmul_plain",
    "window_bwd",
    "window_bwd_plain",
    "window_dw",
    "window_dw_plain",
    "window_gather_matmul",
    "window_gather_matmul_bs",
    "window_gather_matmul_bs_plain",
    "window_gather_matmul_plain",
    "window_match",
    "window_match_plain",
    "window_starts",
    "window_starts_plain",
]
