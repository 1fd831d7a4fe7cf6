"""SumProfiler: cumulative action durations + call counts (counterpart of
``nerf_downstream_tpu/train/profilers.py``).

Host wall time per action, as the reference's: a section around a step
that is not synchronised times its dispatch. ``device_trace`` is the
counterpart of the reference's ``jax.profiler`` trace: a
``torch.profiler`` context that writes a Chrome trace of the host and
(on the card) the device under a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class SumProfiler:
    def __init__(self):
        self.reset()

    def reset(self):
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._starts: dict[str, float] = {}

    def start(self, action: str):
        self._starts[action] = time.perf_counter()

    def stop(self, action: str):
        t0 = self._starts.pop(action, None)
        if t0 is None:
            return
        self._totals[action] += time.perf_counter() - t0
        self._counts[action] += 1

    @contextlib.contextmanager
    def profile(self, action: str):
        self.start(action)
        try:
            yield
        finally:
            self.stop(action)

    def recorded_time(self, action: str) -> float:
        """Mean duration of an action (reference ``profiler_time`` accessor,
        lightning_module_base.py:50-54)."""
        c = self._counts.get(action, 0)
        return self._totals.get(action, 0.0) / c if c else 0.0

    def summary(self) -> str:
        header = f"{'Action':<40}{'Total (s)':>12}{'Calls':>8}{'Mean (s)':>12}"
        lines = [header, "-" * len(header)]
        for action in sorted(self._totals, key=self._totals.get, reverse=True):
            t = self._totals[action]
            c = self._counts[action]
            lines.append(f"{action:<40}{t:>12.4f}{c:>8}{t / max(c, 1):>12.5f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace what runs inside the context with ``torch.profiler`` (host
    ops, and device kernels where CUDA is available) and write it as a
    Chrome trace, ``<logdir>/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
