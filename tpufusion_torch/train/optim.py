"""The optimizer pieces the trainers use, with optax's semantics (the
reference builds them from optax; this module stands in for it):

  Adam                   `optax.adam`: b1 0.9, b2 0.999, eps 1e-8 added
                         outside the root of the bias-corrected second
                         moment, the step count starting at 1
  every_k (of Adam)      `optax.MultiSteps`: the running mean of k
                         micro-gradients, one update on every k-th call,
                         no parameter change between
  cosine_decay_schedule  `optax.cosine_decay_schedule`: a `LambdaLR` that
                         stays at alpha * init after decay_steps (torch's
                         `CosineAnnealingLR` rises again), counted in
                         updates, not micro-steps
  warmup_cosine_decay_schedule
                         `optax.warmup_cosine_decay_schedule`: a linear
                         warmup, then a cosine over the remaining steps
                         down to an absolute end value, in float32
  ReduceOnPlateau        `optax.contrib.reduce_on_plateau`, which is not
                         `torch.optim.lr_scheduler.ReduceLROnPlateau`: a
                         running mean over `accumulation_size` values; an
                         improvement is `avg < (1 - rtol) * best - atol`;
                         the scale drops when the plateau count EQUALS
                         `patience` (torch: exceeds it); `best` keeps
                         updating during cooldown; and the new scale
                         already applies to the update that closed the
                         window

`Adam.step(value=loss)` feeds the plateau rule; the loss stays a tensor
on the device and so does the scale, so a step never waits for the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR


class ReduceOnPlateau:
    """State and rule of `optax.contrib.reduce_on_plateau`, kept as 0-d
    tensors on `device` and updated without a host read. `update(value)`
    takes one loss value and returns the scale for this very update."""

    _FIELDS = ("scale", "best_value", "plateau_count", "cooldown_count", "count", "avg_value")

    def __init__(self, factor: float = 0.1, patience: int = 10, rtol: float = 1e-4,
                 atol: float = 0.0, cooldown: int = 0, accumulation_size: int = 1,
                 min_scale: float = 0.0, device: torch.device | str = "cuda"):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        if rtol < 0.0 or atol < 0.0 or (rtol == 0.0 and atol == 0.0) or rtol > 1.0:
            raise ValueError(f"rtol in [0, 1], atol >= 0, not both 0; got {rtol}, {atol}")
        self.factor, self.patience, self.rtol, self.atol = factor, patience, rtol, atol
        self.cooldown, self.accumulation_size = cooldown, accumulation_size
        self.min_scale = min_scale
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.scale = torch.tensor(1.0, **f32)
        self.best_value = torch.tensor(float("inf"), **f32)
        self.plateau_count = torch.tensor(0, **i32)
        self.cooldown_count = torch.tensor(0, **i32)
        self.count = torch.tensor(0, **i32)
        self.avg_value = torch.tensor(0.0, **f32)

    @torch.no_grad()
    def update(self, value: torch.Tensor) -> torch.Tensor:
        value = torch.as_tensor(value, dtype=torch.float32, device=self.scale.device).detach()
        new_count = self.count + 1
        avg = (self.count * self.avg_value + value) / new_count
        window = new_count == self.accumulation_size  # the rule runs once a window

        improved = avg < (1 - self.rtol) * self.best_value - self.atol
        best = torch.where(improved, avg, self.best_value)
        plateau = torch.where(improved, 0, self.plateau_count + 1)
        cooling = self.cooldown_count > 0
        hit = (plateau == self.patience) & ~cooling
        scale = torch.where(hit, self.scale * self.factor, self.scale).clamp(min=self.min_scale)
        new_plateau = torch.where(cooling | hit, 0, plateau)
        new_cooldown = torch.where(
            cooling, self.cooldown_count - 1, torch.where(hit, self.cooldown, 0))

        self.scale = torch.where(window, scale, self.scale)
        self.best_value = torch.where(window, best, self.best_value)
        self.plateau_count = torch.where(window, new_plateau, self.plateau_count).to(torch.int32)
        self.cooldown_count = torch.where(window, new_cooldown, self.cooldown_count).to(torch.int32)
        self.count = torch.where(window, 0, new_count).to(torch.int32)
        self.avg_value = torch.where(window, 0.0, avg)
        return self.scale

    def state_dict(self) -> dict:
        return {k: getattr(self, k).clone() for k in self._FIELDS}

    def load_state_dict(self, state: dict) -> None:
        for k in self._FIELDS:
            setattr(self, k, state[k].to(self.scale.device))


class Adam(torch.optim.Optimizer):
    """`optax.adam(lr)`, optionally under `optax.MultiSteps(every_k)` and
    chained with `reduce_on_plateau` (`plateau`).

    `step(value=None)` takes the gradients in `.grad`: it folds them into
    the running mean of the micro-gradients and, on every `every_k`-th
    call, applies one Adam update from that mean, advances `scheduler`
    (set by `cosine_decay_schedule`) and returns True. `plateau` given,
    `value` (the loss, a tensor) is fed to it and its scale multiplies the
    update. A parameter without a gradient counts as a zero gradient.
    `state_dict()` carries the moments, the counts, the accumulated
    gradients, the scheduler and the plateau state."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, every_k: int = 1, plateau: ReduceOnPlateau | None = None):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.every_k = every_k
        self.plateau = plateau
        self.scheduler: LambdaLR | None = None
        self.count = 0  # Adam updates applied
        self.mini_step = 0  # micro-gradients in the running mean

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["mu"] = torch.zeros_like(p)
            state["nu"] = torch.zeros_like(p)
            if self.every_k > 1:
                state["acc"] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def step(self, value: torch.Tensor | None = None) -> bool:
        emit = self.mini_step == self.every_k - 1
        scale = self.plateau.update(value) if self.plateau is not None and emit else None
        if emit:
            self.count += 1
        for group in self.param_groups:
            params = group["params"]
            states = [self._state(p) for p in params]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            if self.every_k > 1:
                # acc += (g - acc) / (n + 1): the mean of the micro-gradients so far
                acc = [s["acc"] for s in states]
                delta = torch._foreach_sub(grads, acc)
                torch._foreach_add_(acc, delta, alpha=1.0 / (self.mini_step + 1))
                grads = acc
            if not emit:
                continue
            b1, b2 = group["b1"], group["b2"]
            mu, nu = [s["mu"] for s in states], [s["nu"] for s in states]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            denom = torch._foreach_div(nu, 1 - b2 ** self.count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mu, denom)
            torch._foreach_mul_(update, -group["lr"] / (1 - b1 ** self.count))
            if scale is not None:
                torch._foreach_mul_(update, scale)
            torch._foreach_add_(params, update)
            if self.every_k > 1:
                torch._foreach_zero_(acc)
        self.mini_step = (self.mini_step + 1) % self.every_k
        if emit and self.scheduler is not None:
            self.scheduler.step()
        return emit

    def state_dict(self) -> dict:
        out = super().state_dict()
        out["count"], out["mini_step"] = self.count, self.mini_step
        if self.scheduler is not None:
            out["scheduler"] = self.scheduler.state_dict()  # its function is not stored
        if self.plateau is not None:
            out["plateau"] = self.plateau.state_dict()
        return out

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        self.count, self.mini_step = state.pop("count"), state.pop("mini_step")
        sched, plateau = state.pop("scheduler", None), state.pop("plateau", None)
        super().load_state_dict(state)
        if self.scheduler is not None and sched is not None:
            self.scheduler.load_state_dict(sched)
        if self.plateau is not None and plateau is not None:
            self.plateau.load_state_dict(plateau)


def cosine_decay_schedule(optimizer: Adam, decay_steps: int, alpha: float = 0.0) -> LambdaLR:
    """`optax.cosine_decay_schedule(init, decay_steps, alpha)` with init
    the optimizer's lr: after n updates the lr is init * ((1 - alpha) *
    0.5 * (1 + cos(pi * min(n, decay_steps) / decay_steps)) + alpha). The
    optimizer advances it after each update it applies."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def factor(n: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(n, decay_steps) / decay_steps))
        return (1.0 - alpha) * cosine + alpha

    optimizer.scheduler = LambdaLR(optimizer, factor)
    return optimizer.scheduler


def warmup_cosine_value(n: int, peak_value: float, warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0, init_value: float = 0.0) -> float:
    """`optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps, end_value)(n)`, computed in float32 in
    optax's order: a line from init to peak over the first warmup_steps
    counts, then init = peak, alpha = end / peak cosine-decayed over
    decay_steps - warmup_steps counts (not decay_steps) and held at
    peak * alpha after. The cosine is the float64 one rounded to float32,
    where XLA's own float32 cosine may differ from it by an ulp."""
    f32 = np.float32
    if n < warmup_steps:
        frac = f32(1.0) - f32(max(n, 0)) / f32(warmup_steps)
        return float(f32(f32(init_value - peak_value) * frac) + f32(peak_value))
    span = decay_steps - warmup_steps
    count = f32(min(n - warmup_steps, span))
    angle = f32(f32(math.pi) * count) / f32(span)
    cosine = f32(0.5) * (f32(1.0) + f32(math.cos(float(angle))))
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return float(f32(peak_value) * (f32(1.0 - alpha) * cosine + f32(alpha)))


def warmup_cosine_decay_schedule(optimizer: Adam, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 init_value: float = 0.0) -> LambdaLR:
    """The optimizer's lr follows `warmup_cosine_value`: update k (from 1)
    runs at its value for k - 1, so the first update runs at init_value
    (0 in the detector tool: the first step moves nothing). The schedule's
    values are the rates themselves; the optimizer's own lr is replaced.
    The optimizer advances it after each update it applies."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    for group in optimizer.param_groups:
        group["lr"] = 1.0  # LambdaLR multiplies its base lr by the schedule's value

    def value(n: int) -> float:
        return warmup_cosine_value(n, peak_value, warmup_steps, decay_steps, end_value, init_value)

    optimizer.scheduler = LambdaLR(optimizer, value)
    return optimizer.scheduler
