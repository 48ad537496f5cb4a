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

:func:`expert_parallel_ffn` is the layer over a mesh
(bifold_tpu/ops/moe.py:159-198, and ``moe_ffn`` under GSPMD when the batch
is cut over data ranks): the same routing, the same capacity and the same
outputs as one device running JAX's layer on the global batch, computed by
the ranks that hold its tokens and experts. See its docstring.
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


def _choices(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """Each token's expert in each of the greedy passes of :func:`route`
    (T, k): a token's own probabilities decide them, its slot and whether
    it is kept depend on the tokens before it."""
    e = probs.shape[-1]
    masked, out = probs.detach(), []
    for _ in range(top_k):
        choice = masked.argmax(dim=-1)
        out.append(choice)
        masked = masked * (1.0 - F.one_hot(choice, e).to(masked.dtype))
    return torch.stack(out, dim=1)


def _kept(choices: torch.Tensor, groups: int, cap: int, e: int) -> torch.Tensor:
    """Which (token, pass) keeps its slot (T, k) bool, for ``choices`` of
    the global token order cut into ``groups`` contiguous routing groups of
    ``cap`` slots per expert: :func:`route`'s cumsum positions, the slots
    used by earlier passes counted."""
    t, k = choices.shape
    c = choices.view(groups, t // groups, k)
    used = torch.zeros((groups, 1, e), dtype=torch.int64, device=choices.device)
    keep = []
    for p in range(k):
        onehot = F.one_hot(c[:, :, p], e)                         # (G, n, E)
        pos = ((onehot.cumsum(dim=1) - 1) * onehot + onehot * used).sum(dim=-1)
        kept = pos < cap
        used = used + (onehot * kept[..., None]).sum(dim=1, keepdim=True)
        keep.append(kept)
    return torch.stack(keep, dim=-1).view(t, k)


def _expert_rows(rows, expert, w1, b1, w2, b2):
    """Each row through its expert's fc1 -> exact gelu -> fc2 in float32
    (``expert`` indexes the local experts)."""
    order = torch.argsort(expert, stable=True)
    counts = torch.bincount(expert, minlength=w1.shape[0]).tolist()
    parts = [F.gelu(seg @ w1[i].float() + b1[i].float()) @ w2[i].float() + b2[i].float()
             for i, seg in enumerate(rows[order].split(counts))]
    return torch.cat(parts)[torch.argsort(order)]


def expert_parallel_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], mesh, *,
                        top_k: int = 1, capacity_factor: float = 1.25,
                        return_aux: bool = False):
    """The MoE FFN over (..., D) on this rank of ``mesh`` (a
    :class:`~bifold_tpu_torch.parallel.Mesh`), equal to JAX's layer on the
    global batch:

    - routing follows the global token order (the data ranks' slices in
      order): where the experts are cut over ep and ep divides the global
      tokens, ep shard ``j`` routes the ``j``-th contiguous chunk of it
      with capacity ``capacity(T / ep, ...)`` (``expert_parallel_ffn``),
      else the whole of it is one group (``moe_ffn`` under GSPMD). Only
      the choices cross ranks: each token's experts are its own (greedy
      passes over its probabilities), the data ranks' choices are gathered
      (ints), and every rank computes the keep decisions of its tokens
      from them, the slots of earlier passes counted;
    - ``params``: ``router`` whole, ``w1 b1 w2 b2`` this rank's experts, the
      ``j``-th of ``ep`` equal parts (the ep group holds the same tokens;
      each ep rank sends its share of them, ``torch.tensor_split``'s cut,
      to the experts' owners by :func:`all_to_all`, which runs them in
      float32 and sends the outputs back), or every expert (no exchange);
    - a token's output is the sum over its kept passes of gate x expert
      output, 0 when every pass dropped it, cast to ``x``'s dtype;
    - ``return_aux``: also this rank's share of the Switch load-balance loss
      (its tokens' router probabilities against the global first-choice
      fractions), so that the shares of the data ranks sum to JAX's aux."""
    # the collectives' package imports the models, which import this module
    from bifold_tpu_torch.parallel.collectives import (SELF, all_gather, all_to_all,
                                                       chunk_bounds, gather_from_group,
                                                       group_size, split_to_group)

    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    router = params["router"]
    e = router.shape[-1]
    probs = torch.softmax(x2.float() @ router.float(), dim=-1)    # (T_loc, E)
    choices = _choices(probs, top_k)
    every = all_gather(choices, mesh.groups["data"])                   # (T, k)
    t, t_loc = every.shape[0], x2.shape[0]
    local = params["w1"].shape[0]
    ep = mesh.groups["ep"] if local != e else SELF
    groups = group_size(ep) if t % group_size(ep) == 0 else 1
    cap = capacity(t // groups, e, top_k, capacity_factor)
    start = mesh.data_rank * t_loc
    keep = _kept(every, groups, cap, e)[start:start + t_loc]

    xs, ps = split_to_group(x2, 0, ep), split_to_group(probs, 0, ep)
    lo, hi = chunk_bounds(t_loc, group_size(ep), mesh.coords["ep"] if ep is not SELF else 0)
    mine = choices[lo:hi]
    token, slot = keep[lo:hi].nonzero(as_tuple=True)
    expert = mine[token, slot]
    owner = torch.div(expert, local, rounding_mode="floor")
    order = torch.argsort(owner, stable=True)
    token, slot, expert, owner = token[order], slot[order], expert[order], owner[order]
    send_rows = torch.bincount(owner, minlength=group_size(ep)).tolist()
    rows, got = all_to_all(xs.float()[token], send_rows, ep)
    which, _ = all_to_all(expert - owner * local, send_rows, ep, recv_rows=got)
    y = _expert_rows(rows, which, *(params[k] for k in ("w1", "b1", "w2", "b2")))
    back, _ = all_to_all(y, got, ep, recv_rows=send_rows)
    gate = ps.gather(1, mine)[token, slot]
    out = torch.zeros((xs.shape[0], d), dtype=torch.float32, device=x.device)
    out = out.index_add(0, token, back * gate[:, None])
    out = gather_from_group(out, 0, t_loc, ep).to(x.dtype).reshape(*lead, d)
    if not return_aux:
        return out
    first = torch.bincount(every[:, 0], minlength=e).float()   # global, no gradient
    aux = e * torch.sum(first / t * (probs.sum(dim=0) / t))
    return out, aux
