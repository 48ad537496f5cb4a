"""Losses over heatmap dicts.

Counterpart of bifold_tpu/losses/__init__.py:44-203. A loss is a function
``loss_fn(output, sample, batch_share=1.0) -> (scalar, intermediates)``
built from its config node by :func:`build_loss` (``name`` plus the
factory's keywords).

Each term says how it reduces over the batch, for data parallelism: a term
that takes the mean over the batch (``bce_gaussmap``, ``bce_mask``) is
multiplied by ``batch_share`` (this rank's samples over the global batch's),
a term that sums over the batch (``dice``, and ``focal``'s
``mean(1).sum()``) is left as it is, so that summing each rank's value
gives the global batch's. ``batch_share`` 1 (one process) changes nothing.

:func:`binary_cross_entropy` is written as the JAX package writes it, not as
``F.binary_cross_entropy``: its value clamps each log term at -100 (torch's
``BCELoss``), and its gradient goes through p clipped to [1e-12, 1 - 1e-6],
so a sigmoid saturated at exactly 0 or 1 gives a finite gradient.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

__all__ = ["LOSSES", "build_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "bce_gaussmap", "bce_mask",
           "dice", "focal", "composed"]

LossFn = Callable[[Dict[str, Any], Dict[str, Any]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]

_LOG_CLAMP = -100.0  # torch.nn.BCELoss clamps each log term here


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def binary_cross_entropy(p, target, reduction: str = "mean"):
    """Elementwise BCE on probabilities: value with the -100 log clamp,
    gradient d(safe)/dp through the eps-clipped p."""
    p = p.float()
    target = target.float()
    p_safe = p.clamp(1e-12, 1.0 - 1e-6)
    safe = -(target * torch.log(p_safe) + (1.0 - target) * torch.log1p(-p_safe))
    log_p = torch.log(p).clamp_min(_LOG_CLAMP)
    log_1p = torch.log1p(-p).clamp_min(_LOG_CLAMP)
    exact = -(target * log_p + (1.0 - target) * log_1p)
    return _reduce(safe + (exact - safe).detach(), reduction)


def binary_cross_entropy_with_logits(x, target, reduction: str = "mean"):
    """Fused sigmoid + BCE on logits: max(x, 0) - x t + log1p(exp(-|x|)).
    max(x, 0) is ``relu``, whose gradient at x = 0 is 0, as the JAX
    package's ``jnp.maximum(x, 0.0)`` gives: a logit of exactly 0 (a UNet
    pixel whose channels the last ReLU all zeroed, under a zero head bias)
    then gets JAX's gradient, -t, not sigmoid(0) - t."""
    x = x.float()
    target = target.float()
    loss = torch.relu(x) - x * target + torch.log1p(torch.exp(-x.abs()))
    return _reduce(loss, reduction)


def _batch_mean(term, batch_share):
    """A term averaged over this rank's batch, as its share of the global
    batch's average."""
    return term if batch_share == 1.0 else term * batch_share


def _squeeze_mask(mask):
    """(B, 1, H, W) or (B, H, W) -> (B, H, W)."""
    return mask[:, 0] if mask.dim() == 4 else mask


def bce_gaussmap(is_bimanual: bool, mask_pick_heatmap: bool = False, **_) -> LossFn:
    """Per-head BCE of the heatmaps against the Gaussian targets, summed over
    {pick, place} x arms: on the logits where the output has them, else on
    the heatmap probabilities. ``mask_pick_heatmap`` gates pick targets by
    the cloth mask."""
    heads = (("left_pick", "right_pick", "left_place", "right_place")
             if is_bimanual else ("pick", "place"))

    def loss_fn(output, sample, batch_share=1.0):
        intermediates = {}
        total = 0.0
        for head in heads:
            target = sample[f"{head}_heatmap"]
            if head.endswith("pick") and mask_pick_heatmap:
                target = target * _squeeze_mask(sample["mask"])
            if f"{head}_logits" in output:
                curr = binary_cross_entropy_with_logits(
                    output[f"{head}_logits"], target)
            else:
                curr = binary_cross_entropy(output[f"{head}_heatmap"], target)
            curr = _batch_mean(curr, batch_share)
            intermediates[head] = curr
            total = total + curr
        return total, intermediates

    return loss_fn


def bce_mask(**_) -> LossFn:
    """BCE of the mask head against the cloth mask."""

    def loss_fn(output, sample, batch_share=1.0):
        return _batch_mean(binary_cross_entropy(output["mask_heatmap"],
                                                _squeeze_mask(sample["mask"])),
                           batch_share), {}

    return loss_fn


def dice(**_) -> LossFn:
    """Dice loss on the mask head, summed over the batch."""

    def loss_fn(output, sample, batch_share=1.0):
        inputs = output["mask_heatmap"].reshape(output["mask_heatmap"].shape[0], -1)
        targets = _squeeze_mask(sample["mask"]).reshape(inputs.shape[0], -1).float()
        numerator = 2.0 * (inputs * targets).sum(dim=1)
        denominator = inputs.sum(dim=-1) + targets.sum(dim=-1)
        return (1.0 - (numerator + 1.0) / (denominator + 1.0)).sum(), {}

    return loss_fn


def focal(alpha: float = 0.25, gamma: float = 2.0, **_) -> LossFn:
    """Focal loss on the mask head with the reference's reduction,
    ``loss.mean(1).sum()`` over a (B, H, W) map (mean over rows, then the
    sum over batch and columns)."""

    def loss_fn(output, sample, batch_share=1.0):
        prob = output["mask_heatmap"].float()
        targets = _squeeze_mask(sample["mask"]).float()
        ce = binary_cross_entropy(prob, targets, reduction="none")
        p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
        loss = ce * (1.0 - p_t) ** gamma
        if alpha >= 0:
            loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
        return loss.mean(dim=1).sum(), {}

    return loss_fn


def composed(loss_names, weights, **kwargs) -> LossFn:
    """Weighted sum of named losses; intermediates keep each loss's value
    under its name and its own intermediates as ``"<name> <key>"``."""
    if len(loss_names) != len(weights):
        raise ValueError("composed: one weight per loss")
    parts = {name: LOSSES[name](**kwargs) for name in loss_names}
    weight_of = dict(zip(loss_names, weights))

    def loss_fn(output, sample, batch_share=1.0):
        intermediates = {}
        total = 0.0
        for name, fn in parts.items():
            curr, curr_inter = fn(output, sample, batch_share)
            total = total + curr * weight_of[name]
            intermediates[name] = curr
            for k, v in curr_inter.items():
                intermediates[f"{name} {k}"] = v
        return total, intermediates

    return loss_fn


LOSSES = {"bce_gaussmap": bce_gaussmap, "bce_mask": bce_mask, "dice": dice,
          "focal": focal, "composed": composed}


def build_loss(cfg: dict) -> LossFn:
    """A loss from its config node; the keys other than ``name`` are the
    factory's keywords."""
    node = dict(cfg)
    name = node.pop("name")
    if name not in LOSSES:
        raise KeyError(f"loss {name!r} is not ported (have {sorted(LOSSES)})")
    return LOSSES[name](**node)
