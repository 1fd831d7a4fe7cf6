"""SGD and learning-rate schedules (counterpart of
``nerf_downstream_tpu/train/optim.py``, SGD only).

``sgd`` is ``torch.optim.SGD`` with torch's coupled weight decay,
momentum and Nesterov: the reference's optax chain (``add_decayed_weights``
then ``sgd``) computes the same update. The reference has no dampening
(optax's momentum trace takes none, and its ``sgd`` drops the argument), so
``sgd`` refuses a nonzero ``dampening`` where it would act, with momentum;
without momentum torch ignores it too. Every
schedule is a plain ``step -> lr`` function; the training step sets the
group's lr from it with the step count before the update, as optax indexes
its schedules. Values the reference reads back from its gin configuration
(``train.max_steps``, ``train.scheduler_interval``) are explicit arguments
here; ``get_scheduler`` fills them from the configuration when the caller
leaves them out. The optimizer and every schedule are gin-configurable
under the reference's names (``SGD.momentum = 0.9``,
``CosineAnnealingLR.eta_min``); optimizers other than SGD are not ported
(ROADMAP.md Queue 1 item 1).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from nerf_downstream_tpu_torch import config as cfg


@cfg.configurable("SGD")
def sgd(params: Iterable, lr: float, weight_decay: float = 0.0,
        momentum: float = 0.0, dampening: float = 0.0,
        nesterov: bool = False) -> torch.optim.SGD:
    if dampening != 0 and momentum != 0:
        raise ValueError(
            f"SGD dampening {dampening} with momentum {momentum}: the "
            "reference's SGD has no dampening (optax), so the updates would "
            "differ")
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           dampening=dampening, weight_decay=weight_decay,
                           nesterov=nesterov)


OPTIMIZERS = {"SGD": sgd}


def get_optimizer(optimizer_name: str, params: Iterable, lr: float,
                  weight_decay: float = 0.0):
    """The named optimizer over ``params`` with ``lr`` and coupled weight
    decay (the reference's ``get_optimizer``); its other arguments
    (``momentum``, ``nesterov``, ...) come from the gin bindings of its
    name."""
    if optimizer_name not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {optimizer_name} is not ported (have "
            f"{list(OPTIMIZERS)}; ROADMAP.md Queue 1 item 1)")
    return OPTIMIZERS[optimizer_name](params, lr, weight_decay=weight_decay)


@cfg.configurable("StepLR")
def step_lr(base_lr, step_size=20000, gamma=0.1) -> Callable:
    return lambda step: base_lr * gamma ** (step // step_size)


@cfg.configurable("MultiStepLR")
def multi_step_lr(base_lr, milestones=(20000, 40000), gamma=0.1) -> Callable:
    return lambda step: base_lr * gamma ** sum(step >= m for m in milestones)


@cfg.configurable("ExponentialLR")
def exponential_lr(base_lr, gamma=0.99) -> Callable:
    return lambda step: base_lr * gamma ** step


@cfg.configurable("CosineAnnealingLR")
def cosine_annealing_lr(base_lr, max_steps, eta_min=0.0) -> Callable:
    """``max_steps`` is the reference's T_max (``train.max_steps``, or
    ``train.max_epochs`` with an epoch interval)."""
    return lambda step: eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * step / max_steps)) / 2


@cfg.configurable("CyclicLR")
def cyclic_lr(max_lr, base_lr=1e-4, step_size_up=2000, mode="triangular",
              gamma=1.0, max_steps=None) -> Callable:
    """Cyclic lr between the floor ``base_lr`` and ``max_lr`` (the run's
    lr, ``train.lr`` in the reference); ``max_steps`` is read by the
    cosine mode only."""
    total = 2 * step_size_up
    if mode not in ("triangular", "triangular2", "exp_range", "cosine"):
        raise ValueError(f"Invalid mode:{mode}")

    def schedule(step):
        cycle = math.floor(1 + step / total)
        x = abs(step / step_size_up - 2 * cycle + 1)
        amp = max(0.0, 1 - x)
        if mode == "triangular":
            scale = 1.0
        elif mode == "triangular2":
            scale = 1.0 / (2.0 ** (cycle - 1))
        elif mode == "exp_range":
            scale = gamma ** cycle
        else:
            scale = (1 + math.cos(cycle / (max_steps / total) * math.pi)) / 2
        return base_lr + (max_lr - base_lr) * amp * scale

    return schedule


@cfg.configurable("PolyLR")
def poly_lr(base_lr, max_steps, poly_exp=0.9) -> Callable:
    return lambda step: base_lr * (1 - step / (max_steps + 1)) ** poly_exp


@cfg.configurable("SquaredLR")
def squared_lr(base_lr, max_iter) -> Callable:
    return lambda step: base_lr * (1 - step / (max_iter + 1)) ** 2


SCHEDULERS = {
    "StepLR": step_lr,
    "MultiStepLR": multi_step_lr,
    "ExponentialLR": exponential_lr,
    "CosineAnnealingLR": cosine_annealing_lr,
    "CyclicLR": cyclic_lr,
    "PolyLR": poly_lr,
    "SquaredLR": squared_lr,
}


def warmup_wrap(schedule: Callable, base_lr, warmup_steps: int) -> Callable:
    """Linear 0 -> ``base_lr`` over ``warmup_steps``, then ``schedule``
    shifted by them (GradualWarmupScheduler with multiplier 1)."""

    def warmed(step):
        if step <= warmup_steps:
            return base_lr * step / warmup_steps
        return schedule(max(step - warmup_steps, 0))

    return warmed


def get_scheduler(scheduler_name: str, lr, warmup_steps: int | None = None,
                  **kwargs) -> Callable | None:
    """``step -> lr`` of the named schedule from the run's ``lr`` (None for
    "none"), wrapped in a linear warmup when ``warmup_steps`` > 0.
    ``kwargs`` go to the schedule (for example ``max_steps``, or CyclicLR's
    floor ``base_lr``)."""
    if scheduler_name.lower() == "none":
        return None
    if scheduler_name not in SCHEDULERS:
        raise ValueError(f"scheduler {scheduler_name} not recognized in "
                         f"{list(SCHEDULERS)}")
    kwargs = dict(_configured_lengths(scheduler_name), **kwargs)
    schedule = SCHEDULERS[scheduler_name](lr, **kwargs)
    if warmup_steps is not None and warmup_steps > 0:
        schedule = warmup_wrap(schedule, lr, warmup_steps)
    return schedule


def _configured_lengths(scheduler_name: str) -> dict:
    """The schedule lengths the reference reads back from its
    configuration (``train.max_steps``, or ``train.max_epochs`` for a
    cosine schedule with an epoch interval), where they are bound."""
    q = cfg.query_parameter
    steps = q("train.max_steps", default=None)
    if scheduler_name == "CosineAnnealingLR":
        if q("train.scheduler_interval", default="step") != "step":
            steps = q("train.max_epochs", default=None)
        out = {"max_steps": steps}
    elif scheduler_name in ("PolyLR", "CyclicLR"):
        out = {"max_steps": steps}
    elif scheduler_name == "SquaredLR":
        bound = q("SquaredLR.max_iter", default=None)
        out = {"max_iter": steps if bound is None else bound}
    else:
        out = {}
    return {k: v for k, v in out.items() if v is not None}
