"""Optimizers and learning-rate schedules, written to match optax exactly.

Counterpart of bifold_tpu/optim/__init__.py:30-138. The JAX package builds
an optax chain; this module applies the same chain, in the same order and
with the same float32 formulas, to a list of torch parameters in place:

    [apply_if_finite(                      skip_nonfinite > 0
        clip_by_global_norm(gradient_clip)  gradient_clip set
        -> <optimizer>
        -> scale by -schedule(count))]      count before the update

- ``adam``: torch.optim.Adam's semantics, i.e. COUPLED L2 (wd * p joins the
  gradient before the moments, optax ``add_decayed_weights`` then adam);
- ``adamw``: decoupled weight decay added after the Adam rescaling;
- ``sgd``: optional momentum trace (optax ``trace``), optional nesterov.

The clip is optax's ``(g / norm) * max_norm`` when ``norm >= max_norm``, over
the trainable gradients only (the parameters given), written out because
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm. Frozen parameters
are simply not handed to the optimizer (the JAX package masks them with
``optax.set_to_zero``). ``accumulate_steps`` (optax.MultiSteps) is not
ported.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["build_optimizer", "build_schedule", "Optimizer", "OPTIMIZERS",
           "SCHEDULERS"]

Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# Schedules (optax.schedules, evaluated in float32 as optax does)
# ---------------------------------------------------------------------------


def _f32(x) -> float:
    return float(np.float32(x))


def constant_schedule(value: float) -> Schedule:
    return lambda count: _f32(value)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``transition_steps``, then
    end; a non-positive ``transition_steps`` holds ``init_value``."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return _f32(np.float32(init_value - end_value) * frac
                    + np.float32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps), dtype=np.float32))
        return _f32(np.float32(init_value)
                    * (np.float32(1 - alpha) * cosine + np.float32(alpha)))

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps])


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule


def _linear_warmup(base_lr: float, max_iters: int, warmup_portion: float = 0.1,
                   warmup_start_lr: float = 0.0, use_cosine_decay: bool = True,
                   **_) -> Schedule:
    """The reference LinearWarmup: linear warmup over ``warmup_portion`` of
    ``max_iters`` from ``warmup_start_lr`` to ``base_lr``, then cosine to 0
    (or constant)."""
    warmup_steps = int(warmup_portion * max_iters)
    if use_cosine_decay:
        return warmup_cosine_decay_schedule(warmup_start_lr, base_lr,
                                            warmup_steps, max_iters, 0.0)
    return join_schedules([linear_schedule(warmup_start_lr, base_lr, warmup_steps),
                           constant_schedule(base_lr)], [warmup_steps])


SCHEDULERS = {"linear_warmup": _linear_warmup}


def build_schedule(scheduler_cfg: Optional[dict], base_lr: float,
                   max_iters: int) -> Schedule:
    """None or ``name: null`` -> constant ``base_lr``."""
    node = dict(scheduler_cfg or {})
    name = node.pop("name", None)
    if name is None:
        return constant_schedule(base_lr)
    if name not in SCHEDULERS:
        raise KeyError(f"scheduler {name!r} is not ported")
    return SCHEDULERS[name](base_lr=base_lr, max_iters=max_iters, **node)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it."""
    return _f32(np.float32(1) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """The optax chain above, applied in place to ``params`` (float32
    masters) by :meth:`step`. State lives on the parameters' device; the only
    host synchronisation is ``skip_nonfinite``'s decision."""

    def __init__(self, params: List[torch.Tensor], name: str,
                 schedule: Schedule, *, gradient_clip: Optional[float] = None,
                 skip_nonfinite: int = 0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 nesterov: bool = False):
        if name not in ("adam", "adamw", "sgd"):
            raise KeyError(f"optimizer {name!r} is not ported")
        self.params = list(params)
        self.name = name
        self.schedule = schedule
        self.gradient_clip = gradient_clip
        self.skip_nonfinite = int(skip_nonfinite)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum or 0.0)
        self.nesterov = bool(nesterov)
        self.count = 0           # updates applied (the schedule's count)
        self.notfinite_count = 0
        self.total_notfinite = 0
        adam = name in ("adam", "adamw")
        self.mu = [torch.zeros_like(p) for p in self.params] if adam else None
        self.nu = [torch.zeros_like(p) for p in self.params] if adam else None
        self.trace = ([torch.zeros_like(p) for p in self.params]
                      if name == "sgd" and self.momentum else None)

    def _clip(self, grads):
        max_norm = self.gradient_clip
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
        keep = norm < max_norm
        return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]

    def _direction(self, grads):
        """The update before the learning rate (optax's chain without its
        last ``scale_by_schedule``); advances the moment state."""
        if self.name == "sgd":
            if self.trace is None:
                return grads
            out = []
            for i, g in enumerate(grads):
                self.trace[i] = g + self.momentum * self.trace[i]
                out.append(g + self.momentum * self.trace[i]
                           if self.nesterov else self.trace[i])
            return out
        if self.name == "adam" and self.weight_decay:
            grads = [g + self.weight_decay * p for g, p in zip(grads, self.params)]
        n = self.count + 1
        bc1, bc2 = _bias_correction(self.b1, n), _bias_correction(self.b2, n)
        out = []
        for i, g in enumerate(grads):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
            u = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + self.eps)
            if self.name == "adamw":
                u = u + self.weight_decay * self.params[i]
            out.append(u)
        return out

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update from ``grads`` (aligned with ``params``)."""
        if self.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += 0 if finite else 1
            if not finite and self.notfinite_count <= self.skip_nonfinite:
                return               # params and inner state unchanged
        if self.gradient_clip is not None:
            grads = self._clip(grads)
        updates = self._direction(grads)
        step_size = -self.schedule(self.count)
        for p, u in zip(self.params, updates):
            p.add_(u * step_size)
        self.count += 1


OPTIMIZERS = ("adam", "adamw", "sgd")


def build_optimizer(optim_cfg: dict, params: List[torch.Tensor],
                    scheduler_cfg: Optional[dict] = None, *, max_iters: int = 1,
                    gradient_clip: Optional[float] = None) -> Optimizer:
    """The optimizer of an ``optim`` config node (``name``, ``lr`` and the
    optimizer's keywords, ``skip_nonfinite``) over the trainable ``params``,
    with the ``scheduler`` node's schedule over ``max_iters`` updates."""
    node = dict(optim_cfg)
    name = node.pop("name")
    base_lr = node.pop("lr")
    if int(node.pop("accumulate_steps", 1) or 1) != 1:
        raise NotImplementedError("accumulate_steps > 1 is not ported")
    skip = int(node.pop("skip_nonfinite", 0) or 0)
    schedule = build_schedule(scheduler_cfg, base_lr, max(1, max_iters))
    allowed = {"adam": {"betas", "eps", "weight_decay"},
               "adamw": {"betas", "eps", "weight_decay"},
               "sgd": {"momentum", "nesterov"}}.get(name)
    if allowed is None:
        raise KeyError(f"optimizer {name!r} is not ported (have {OPTIMIZERS})")
    unknown = set(node) - allowed
    if unknown:
        raise TypeError(f"{name} got unknown config keys: {sorted(unknown)}")
    if name == "adamw":
        node.setdefault("weight_decay", 0.01)
    return Optimizer(params, name, schedule, gradient_clip=gradient_clip,
                     skip_nonfinite=skip, **node)
