"""Mixture-of-Experts FFN: static top-k capacity routing, one device.

Counterpart of bifold_tpu/ops/moe.py:53-156 (``init_moe_params``,
``route``, ``_expert_ffn``, ``_capacity``, ``moe_ffn``). The JAX package
runs these as einsums, with no Pallas kernel, and so does the port:

- :func:`route`: softmax router in float32, greedy top-k passes; within a
  pass the slot of a token in its expert is a cumsum over tokens in order
  (earlier tokens win capacity), slots already taken by earlier passes
  counted; tokens past the capacity get all-zero rows (dropped). Dispatch
  and combine are dense one-hot (T, E, C) tensors; the Switch load-balance
  loss ``E * sum_e f_e * P_e`` (f_e: fraction of first choices, no
  gradient; P_e: mean router probability) comes with ``return_aux``;
- :func:`moe_ffn`: (..., D) -> (..., D): the expert batches
  ``dispatch^T x``, each expert's fc1 -> exact gelu -> fc2 batched over E,
  and the gate-weighted combine, all in float32, the output cast back.

:func:`expert_parallel_ffn` (experts sharded over a mesh axis) is not
ported: the port runs on one device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.nn import functional as F

__all__ = ["init_moe_params", "route", "moe_ffn", "expert_parallel_ffn",
           "capacity"]


def init_moe_params(generator: torch.Generator, dim: int, hidden: int,
                    num_experts: int, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Router and per-expert 2-layer FFN parameters in JAX's shapes:
    ``router`` (D, E), ``w1`` (E, D, H), ``b1`` (E, H), ``w2`` (E, H, D),
    ``b2`` (E, D); weights N(0, 0.02), biases 0."""
    device = device if device is not None else generator.device

    def normal(*shape):
        return 0.02 * torch.randn(shape, generator=generator, device=device,
                                  dtype=torch.float32).to(dtype)

    return {"router": normal(dim, num_experts),
            "w1": normal(num_experts, dim, hidden),
            "b1": torch.zeros((num_experts, hidden), dtype=dtype, device=device),
            "w2": normal(num_experts, hidden, dim),
            "b2": torch.zeros((num_experts, dim), dtype=dtype, device=device)}


def route(x: torch.Tensor, router: torch.Tensor, *, top_k: int, capacity: int,
          return_aux: bool = False):
    """(dispatch, combine[, aux]) for tokens ``x`` (T, D) and ``router``
    (D, E): dispatch (T, E, C) in {0, 1}, combine the same times each
    token's gate; both float32 (see the module doc)."""
    t = x.shape[0]
    probs = torch.softmax(x.float() @ router.float(), dim=-1)      # (T, E)
    e = probs.shape[-1]
    aux = None
    if return_aux:
        first = F.one_hot(probs.argmax(dim=-1), e).float()
        aux = e * torch.sum(first.mean(dim=0) * probs.mean(dim=0))
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    used = torch.zeros((e,), dtype=torch.int32, device=x.device)
    masked = probs
    for _ in range(top_k):
        onehot = F.one_hot(masked.argmax(dim=-1), e).float()       # (T, E)
        gate = (masked * onehot).sum(dim=-1)                       # (T,)
        pos = (onehot.cumsum(dim=0) - 1.0) * onehot
        pos_t = pos.sum(dim=-1).to(torch.int32) + \
            (onehot * used[None, :]).sum(dim=-1).to(torch.int32)
        keep = (pos_t < capacity).float()
        slot = F.one_hot(pos_t.clamp(0, capacity - 1).long(), capacity).float()
        d = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        used = used + (onehot * keep[:, None]).sum(dim=0).to(torch.int32)
        masked = masked * (1.0 - onehot)
    if return_aux:
        return dispatch, combine, aux
    return dispatch, combine


def _expert_ffn(expert_in, w1, b1, w2, b2):
    """(E, C, D) -> (E, C, D): per-expert fc1 -> exact gelu -> fc2."""
    h = torch.einsum("ecd,edh->ech", expert_in, w1) + b1[:, None, :]
    h = F.gelu(h)
    return torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]


def capacity(tokens: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert: ceil(T / E * capacity_factor * k), at least 1."""
    return max(1, int(math.ceil(tokens / num_experts * capacity_factor * top_k)))


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], *, top_k: int = 1,
            capacity_factor: float = 1.25, return_aux: bool = False):
    """Dense MoE FFN over (..., D); with ``return_aux`` also the Switch
    load-balance loss of :func:`route`."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    e = params["router"].shape[-1]
    cap = capacity(x2.shape[0], e, top_k, capacity_factor)
    routed = route(x2, params["router"], top_k=top_k, capacity=cap,
                   return_aux=return_aux)
    dispatch, combine = routed[0], routed[1]
    expert_in = torch.einsum("tec,td->ecd", dispatch, x2.float())
    y = _expert_ffn(expert_in, *(params[k].float() for k in ("w1", "b1", "w2", "b2")))
    out = torch.einsum("tec,ecd->td", combine, y).to(x.dtype).reshape(*lead, d)
    return (out, routed[2]) if return_aux else out


def expert_parallel_ffn(*args, **kwargs):
    """Not ported: experts sharded over a mesh axis need more than one
    device (ROADMAP queue item 5, built on :func:`moe_ffn`)."""
    raise NotImplementedError("expert_parallel_ffn: expert parallelism is "
                              "ROADMAP queue item 5; the port runs moe_ffn "
                              "on one device")
