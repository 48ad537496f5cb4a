"""Seeded weights, made on the device in one draw.

The names and shapes come from the configuration's plain reference
(``reference/<config>.py:param_shapes``), the distributions from the
configuration file's ``init`` rules (the first rule whose regex matches a
name): ``ones``; ``normal`` with the rule's scale; ``fan_in``, the scale over
the square root of the fan in (every dim but the first); ``constant``,
the scale itself. One
``torch.randn`` over all the elements, on a generator of the device seeded
from the run's seed, is cut into the tensors, so the same seed gives the
same weights on every run.
"""

from __future__ import annotations

import math
import re

import torch


def make(shapes: dict, rules, seed: int, device, dtype=torch.float32) -> dict:
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    compiled = [(re.compile(rx), kind, float(scale)) for rx, kind, scale in rules]
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at: at + n].view(shape)
        at += n
        kind, scale = next((k, s) for rx, k, s in compiled if rx.search(name))
        if kind == "ones":
            w = torch.ones(shape, device=device)
        elif kind == "normal":
            w = z * scale
        elif kind == "constant":
            w = torch.full(shape, scale, device=device)
        elif kind == "fan_in":
            w = z * (scale / math.sqrt(max(1, math.prod(shape[1:]))))
        else:
            raise ValueError(f"init kind {kind!r} for {name}")
        out[name] = w.to(dtype)
    del flat
    return out
