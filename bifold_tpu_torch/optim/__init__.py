"""Optimizers and learning-rate schedules, written to match optax exactly.

Counterpart of bifold_tpu/optim/__init__.py:30-138. The JAX package builds
an optax chain; this module applies the same chain, in the same order and
with the same float32 formulas, to a list of torch parameters in place:

    [MultiSteps(k,                         accumulate_steps k > 1
        [apply_if_finite(                  skip_nonfinite > 0
            clip_by_global_norm(gradient_clip)  gradient_clip set
            -> <optimizer>
            -> scale by -schedule(count))])]    count before the update

- ``adam``: torch.optim.Adam's semantics, i.e. COUPLED L2 (wd * p joins the
  gradient before the moments, optax ``add_decayed_weights`` then adam);
- ``adamw``: decoupled weight decay added after the Adam rescaling;
- ``sgd``: optional momentum trace (optax ``trace``), optional nesterov.

The clip is optax's ``(g / norm) * max_norm`` when ``norm >= max_norm``, over
the trainable gradients only (the parameters given), written out because
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm. Frozen parameters
are simply not handed to the optimizer (the JAX package masks them with
``optax.set_to_zero``).

``accumulate_steps`` k > 1 is ``optax.MultiSteps``: each micro-step's
gradients join a running mean (``acc + (g - acc) / (n + 1)``, Welford's
form, as optax computes it); every k-th micro-step the inner chain above
updates from the mean, and the accumulator restarts at zero. The clip, the
non-finite check and the schedule act per update, and the schedule spans
``ceil(max_iters / k)`` updates. Inside MultiSteps, ``apply_if_finite``
judges the mean gradient of each update, and its counters advance only on
updates, as they do here. With finite gradients the two agree step for
step. A non-finite micro-gradient differs: here it spoils only its own
update, which ``skip_nonfinite`` skips; optax restarts its accumulator as
0 x acc and adds 0 x update on the other micro-steps, so the NaN stays and
reaches the parameters once the skips run out (a fault of the JAX package,
ROADMAP section 3).

:meth:`Optimizer.state_dict` is the port's own checkpoint form of the
state (the moments keyed by parameter name when the optimizer was given
names); :meth:`Optimizer.load_state_dict` restores it in place.
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
                 skip_nonfinite: int = 0, accumulate_steps: int = 1,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 nesterov: bool = False, names: Optional[List[str]] = None):
        if name not in ("adam", "adamw", "sgd"):
            raise KeyError(f"optimizer {name!r} is not ported")
        self.params = list(params)
        self.names = list(names) if names is not None else [
            str(i) for i in range(len(self.params))]
        if len(self.names) != len(self.params):
            raise ValueError(f"{len(self.names)} names for {len(self.params)} parameters")
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
        self.accumulate_steps = max(1, int(accumulate_steps))
        self.mini_step = 0       # micro-steps in the running mean
        # step() calls begun and returned: an exception that leaves them
        # unequal stopped a call part-way through writing the state
        self.steps_begun = self.steps_done = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accumulate_steps > 1 else None)
        adam = name in ("adam", "adamw")
        self.mu = [torch.zeros_like(p) for p in self.params] if adam else None
        self.nu = [torch.zeros_like(p) for p in self.params] if adam else None
        self.trace = ([torch.zeros_like(p) for p in self.params]
                      if name == "sgd" and self.momentum else None)
        # sharded parameters (parallel.sharding): the norm over every rank's
        # part and one finiteness verdict for all ranks
        self.global_norm: Optional[Callable] = None
        self.all_finite: Optional[Callable] = None

    def _clip(self, grads):
        max_norm = self.gradient_clip
        norm = (self.global_norm(grads) if self.global_norm is not None else
                torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads)))
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
        """One micro-step from ``grads`` (aligned with ``params``): an update
        without accumulation, else a join to the running mean and an update
        from it on every ``accumulate_steps``-th call."""
        self.steps_begun += 1
        if self.acc is None:
            self._update(grads)
        else:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            if n == self.accumulate_steps - 1:
                self._update(self.acc)
                for a in self.acc:
                    a.zero_()
            self.mini_step = (n + 1) % self.accumulate_steps
        self.steps_done += 1

    @property
    def in_update(self) -> bool:
        return self.steps_begun != self.steps_done

    def _update(self, grads: List[torch.Tensor]) -> None:
        if self.skip_nonfinite:
            finite = (self.all_finite(grads) if self.all_finite is not None else
                      bool(torch.stack([torch.isfinite(g).all() for g in grads]).all()))
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

    _MOMENTS = ("mu", "nu", "trace", "acc")

    def state_dict(self) -> dict:
        """The state as host tensors: counters, and each moment list
        (``mu``/``nu`` for Adam, ``trace`` for SGD with momentum, ``acc``
        under accumulation) as a dict keyed by parameter name."""
        out = {"format": "bifold_tpu_torch.optim/1", "name": self.name,
               "count": self.count, "notfinite_count": self.notfinite_count,
               "total_notfinite": self.total_notfinite,
               "accumulate_steps": self.accumulate_steps,
               "mini_step": self.mini_step}
        for key in self._MOMENTS:
            values = getattr(self, key)
            if values is not None:
                out[key] = {n: v.detach().cpu().clone() for n, v in zip(self.names, values)}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output (tensors or arrays) in place.
        A moment absent from ``state`` keeps its value; one of another
        shape, or a moment this optimizer does not keep, raises."""
        if state.get("name", self.name) != self.name:
            raise ValueError(f"optimizer state of {state['name']!r}, not {self.name!r}")
        for key in ("count", "notfinite_count", "total_notfinite", "mini_step"):
            if key in state:
                setattr(self, key, int(state[key]))
        for key in self._MOMENTS:
            if key not in state:
                continue
            values = getattr(self, key)
            if values is None:
                raise ValueError(f"optimizer state carries {key!r}, which {self.name} "
                                 f"(accumulate_steps={self.accumulate_steps}) has not")
            for n, v in zip(self.names, values):
                if n not in state[key]:
                    continue
                saved = torch.as_tensor(state[key][n])
                if saved.shape != v.shape:
                    raise ValueError(f"optimizer {key} of {n}: saved shape "
                                     f"{tuple(saved.shape)}, parameter {tuple(v.shape)}")
                v.copy_(saved)


OPTIMIZERS = ("adam", "adamw", "sgd")


def build_optimizer(optim_cfg: dict, params: List[torch.Tensor],
                    scheduler_cfg: Optional[dict] = None, *, max_iters: int = 1,
                    gradient_clip: Optional[float] = None,
                    names: Optional[List[str]] = None) -> Optimizer:
    """The optimizer of an ``optim`` config node (``name``, ``lr`` and the
    optimizer's keywords, ``skip_nonfinite``, ``accumulate_steps``) over the
    trainable ``params`` (named by ``names`` in its state dict), with the
    ``scheduler`` node's schedule over ``ceil(max_iters /
    accumulate_steps)`` updates (``max_iters`` counts micro-steps)."""
    node = dict(optim_cfg)
    name = node.pop("name")
    base_lr = node.pop("lr")
    accumulate = int(node.pop("accumulate_steps", 1) or 1)
    skip = int(node.pop("skip_nonfinite", 0) or 0)
    schedule = build_schedule(scheduler_cfg, base_lr, max(1, -(-max_iters // accumulate)))
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
                     skip_nonfinite=skip, accumulate_steps=accumulate, names=names,
                     **node)
