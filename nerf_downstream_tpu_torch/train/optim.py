"""Optimizers and learning-rate schedules (counterpart of
``nerf_downstream_tpu/train/optim.py``).

The reference builds every optimizer from optax, so the port computes
optax's formulas, not torch's, under the reference's gin names and
defaults. ``sgd`` is ``torch.optim.SGD`` (torch's coupled weight decay,
momentum and Nesterov compute optax's update); the reference has no
dampening, so ``sgd`` refuses a nonzero ``dampening`` with momentum.
ASGD is plain SGD (no averaging, as in the reference). The others are
``OptaxOptimizer``s written out from optax 0.2.6:

- Adam and Adamax: bias-corrected moments; Adamax's infinity norm is
  ``max(|g| + eps, b2 * nu)``, its update ``mu_hat / nu``.
- AdamW: Adam's update plus ``weight_decay * p`` (decoupled, on every
  leaf: the reference passes no mask), then the lr.
- Adagrad: the accumulator starts at 0.1 and the update is
  ``g * rsqrt(acc + eps)``, 0 where the accumulator is 0.
- Adadelta: ``sqrt(e_x + eps) / sqrt(e_g + eps) * g``.
- RMSprop: eps inside the square root, the second moment from 0, and
  ``momentum`` as a trace of the lr-scaled updates.
- Rprop: per-entry step sizes from the lr, grown by 1.2 and shrunk by
  0.5 within [1e-6, 50]; as in optax, each step applies the previous
  step's signed step (0 at the first, and where the gradient's sign
  flipped); the schedule plays no part (the reference's Rprop refuses
  one).

Every optimizer but AdamW couples ``weight_decay`` into the gradient
before its transform (optax's ``add_decayed_weights``). A parameter
without a gradient takes a zero one, as optax updates every leaf. Each
optimizer's state has optax's leaves under optax's names
(``train/checkpoints.py`` carries them to and from the reference's
optax state). The training step sets the group's lr from the schedule
with the step count before the update, as optax indexes its schedules.

Every schedule is a plain ``step -> lr`` function. Values the reference
reads back from its gin configuration (``train.max_steps``,
``train.scheduler_interval``) are explicit arguments here;
``get_scheduler`` fills them from the configuration when the caller
leaves them out. The optimizers and schedules are gin-configurable under
the reference's names (``SGD.momentum = 0.9``, ``AdamW.b2``,
``CosineAnnealingLR.eta_min``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
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


@cfg.configurable("ASGD")
def asgd(params: Iterable, lr: float, weight_decay: float = 0.0,
         lambd: float = 1e-4, alpha: float = 0.75) -> torch.optim.SGD:
    """Plain SGD, as the reference's ASGD (``lambd`` and ``alpha`` are
    accepted and unused there too)."""
    return torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)


class OptaxOptimizer(torch.optim.Optimizer):
    """An optax chain as a ``torch.optim.Optimizer``: coupled weight decay
    (unless ``decoupled``), the transform ``direction`` (which updates the
    parameter's state in place and returns the update before the lr), and
    ``p -= lr * update``. ``leaves`` names the per-parameter state
    tensors, optax's; ``counted`` transforms keep optax's update
    ``count`` (a Python int per parameter, equal across them)."""

    leaves: tuple = ()
    counted = False
    decoupled = False

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 **hyper):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      **hyper))

    def init_state(self, p: torch.Tensor, group: dict) -> dict:
        """optax's initial state of one parameter."""
        out = {name: torch.zeros_like(p, memory_format=torch.preserve_format)
               for name in self.leaves}
        if self.counted:
            out["count"] = 0
        return out

    def direction(self, p, g, st: dict, group: dict) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, p, u, st: dict, group: dict) -> None:
        p.add_(u, alpha=-group["lr"])

    def state_of(self, p: torch.Tensor, group: dict | None = None) -> dict:
        """The state of ``p`` (of ``group``, found when not given), made as
        optax's initial one if it has none yet."""
        st = self.state[p]
        if not st:
            if group is None:
                group = next(g for g in self.param_groups
                             if any(q is p for q in g["params"]))
            st.update(self.init_state(p, group))
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                if wd and not self.decoupled:
                    g = g + wd * p
                st = self.state_of(p, group)
                if self.counted:
                    st["count"] += 1
                u = self.direction(p, g, st, group)
                if wd and self.decoupled:
                    u = u + wd * p
                self.apply(p, u, st, group)
        return loss


def _moment(t: torch.Tensor, g: torch.Tensor, decay: float) -> None:
    """optax's ``update_moment``: ``t = (1 - decay) * g + decay * t``."""
    t.mul_(decay).add_((1 - decay) * g)


def _bias(t: torch.Tensor, decay: float, count: int) -> torch.Tensor:
    """optax's ``bias_correction``: ``t / (1 - decay ** count)``, the
    correction computed in ``t``'s type on the host (as optax computes it
    in f32: at ``b2 = 0.999`` the difference cancels most of its bits)."""
    one = np.float64(1) if t.dtype == torch.float64 else np.float32(1)
    return t / float(one - (one * decay) ** (one * count))


class Adam(OptaxOptimizer):
    leaves = ("mu", "nu")
    counted = True

    def direction(self, p, g, st, group):
        b1, b2 = group["b1"], group["b2"]
        _moment(st["mu"], g, b1)
        _moment(st["nu"], g * g, b2)
        mu_hat = _bias(st["mu"], b1, st["count"])
        nu_hat = _bias(st["nu"], b2, st["count"])
        return mu_hat / (nu_hat.sqrt() + group["eps"])


class AdamW(Adam):
    decoupled = True


class Adamax(OptaxOptimizer):
    leaves = ("mu", "nu")
    counted = True

    def direction(self, p, g, st, group):
        _moment(st["mu"], g, group["b1"])
        torch.maximum(g.abs() + group["eps"], group["b2"] * st["nu"],
                      out=st["nu"])
        return _bias(st["mu"], group["b1"], st["count"]) / st["nu"]


class Adagrad(OptaxOptimizer):
    leaves = ("sum_of_squares",)
    INITIAL = 0.1  # optax's initial_accumulator_value

    def init_state(self, p, group):
        return {"sum_of_squares": torch.full_like(p, self.INITIAL)}

    def direction(self, p, g, st, group):
        acc = st["sum_of_squares"]
        acc.add_(g * g)
        inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                          torch.zeros((), dtype=acc.dtype, device=acc.device))
        return inv * g


class Adadelta(OptaxOptimizer):
    leaves = ("e_g", "e_x")

    def direction(self, p, g, st, group):
        rho, eps = group["rho"], group["eps"]
        _moment(st["e_g"], g * g, rho)
        u = (st["e_x"] + eps).sqrt() / (st["e_g"] + eps).sqrt() * g
        _moment(st["e_x"], u * u, rho)
        return u


class RMSprop(OptaxOptimizer):
    leaves = ("nu",)

    def init_state(self, p, group):
        out = super().init_state(p, group)
        if group["momentum"]:
            out["trace"] = torch.zeros_like(p)
        return out

    def direction(self, p, g, st, group):
        _moment(st["nu"], g * g, group["alpha"])
        return torch.rsqrt(st["nu"] + group["eps"]) * g

    def apply(self, p, u, st, group):
        if not group["momentum"]:
            return super().apply(p, u, st, group)
        # optax's trace after the lr: t = -lr * u + momentum * t
        t = st["trace"]
        t.mul_(group["momentum"]).add_(u * -group["lr"])
        p.add_(t)


class Rprop(OptaxOptimizer):
    leaves = ("prev_updates", "step_sizes")
    ETA_MINUS, ETA_PLUS = 0.5, 1.2
    MIN_STEP, MAX_STEP = 1e-6, 50.0

    def init_state(self, p, group):
        return {"prev_updates": torch.zeros_like(p),
                "step_sizes": torch.full_like(p, group["initial_step"])}

    def direction(self, p, g, st, group):
        prev, sizes = st["prev_updates"], st["step_sizes"]
        s = g * prev
        grown = torch.where(s > 0, sizes * self.ETA_PLUS,
                            sizes * self.ETA_MINUS)
        sizes.copy_(torch.where(s == 0, sizes,
                                grown.clamp(self.MIN_STEP, self.MAX_STEP)))
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        # optax applies the update of the step before (its first is 0)
        u = torch.where(s < 0, zero, prev)
        prev.copy_(torch.where(s < 0, zero, sizes * torch.sign(g)))
        return u

    def apply(self, p, u, st, group):
        p.sub_(u)  # optax's scale(-1): no lr


@cfg.configurable("Adam")
def adam(params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8):
    return Adam(params, lr, weight_decay, b1=b1, b2=b2, eps=eps)


@cfg.configurable("AdamW")
def adamw(params, lr, weight_decay=1e-2, b1=0.9, b2=0.999, eps=1e-8):
    return AdamW(params, lr, weight_decay, b1=b1, b2=b2, eps=eps)


@cfg.configurable("Adagrad")
def adagrad(params, lr, weight_decay=0.0, eps=1e-10):
    return Adagrad(params, lr, weight_decay, eps=eps)


@cfg.configurable("Adadelta")
def adadelta(params, lr, weight_decay=0.0, rho=0.9, eps=1e-6):
    return Adadelta(params, lr, weight_decay, rho=rho, eps=eps)


@cfg.configurable("Adamax")
def adamax(params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8):
    return Adamax(params, lr, weight_decay, b1=b1, b2=b2, eps=eps)


@cfg.configurable("RMSprop")
def rmsprop(params, lr, weight_decay=0.0, alpha=0.99, eps=1e-8,
            momentum=0.0):
    return RMSprop(params, lr, weight_decay, alpha=alpha, eps=eps,
                   momentum=momentum)


@cfg.configurable("Rprop")
def rprop(params, lr, weight_decay=0.0):
    """``lr`` is the initial step size of every entry."""
    return Rprop(params, lr, weight_decay, initial_step=lr)


OPTIMIZERS = {
    "SGD": sgd,
    "ASGD": asgd,
    "Adam": adam,
    "AdamW": adamw,
    "Adagrad": adagrad,
    "Adadelta": adadelta,
    "Adamax": adamax,
    "RMSprop": rmsprop,
    "Rprop": rprop,
}


def get_optimizer(optimizer_name: str, params: Iterable, lr: float,
                  weight_decay: float = 0.0):
    """The named optimizer over ``params`` with ``lr`` and ``weight_decay``
    (the reference's ``get_optimizer``); its other arguments
    (``momentum``, ``b1``, ...) come from the gin bindings of its
    name."""
    if optimizer_name not in OPTIMIZERS:
        raise ValueError(f"optimizer {optimizer_name} not recognized in "
                         f"{list(OPTIMIZERS)}")
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
