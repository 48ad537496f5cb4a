"""The reference's train steps: preprocess, forward, loss, gradients, Adam.

Plain PyTorch in float32 (or the control's precision), in row blocks whose
gradients add up to the whole batch's: the loss is the sum over heads of the
mean binary cross-entropy of the logits against the Gaussian targets, so a
block's loss is weighted by its share of the batch. The optimizer is Adam
(optax's: bias-corrected moments, eps outside the square root) at a constant
learning rate, without clipping or weight decay, on the leaves the
reference's ``trainable`` names. The dropout seed of step k is the k-th
draw of ``torch.randint(0, 2**62)`` from a CPU generator seeded with the
step state's seed, as the train step under test draws it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import ref_preprocess as preprocess
from ref_common import Prec


def _adam(leaves, grads, m, v, count, opt):
    b1, b2 = opt["betas"]
    lr, eps = float(opt["lr"]), float(opt["eps"])
    bc1 = float(torch.tensor(1.0) - torch.tensor(b1, dtype=torch.float32) ** count)
    bc2 = float(torch.tensor(1.0) - torch.tensor(b2, dtype=torch.float32) ** count)
    with torch.no_grad():
        for n, p in leaves.items():
            g = grads[n]
            m[n] = (1 - b1) * g + b1 * m[n]
            v[n] = (1 - b2) * g * g + b2 * v[n]
            p.add_(-lr * (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps))


def run(ref, cfg, W: dict, batches, steps: int, dropout_seed: int, device,
        prec: Prec, block: int) -> dict:
    """``steps`` steps from the weights ``W`` (float32, on ``device``) on
    ``batches`` [(raw, draws), ...]: the losses, the first step's head
    logits, every trainable leaf's first gradient and its change's norm
    after the first step and after them all."""
    if cfg["train"].get("gradient_clip") is not None:
        raise NotImplementedError("the reference has no gradient clip")
    opt = cfg["train"]["optim"]
    names = [n for n in W if ref.trainable(n)]
    leaves = {n: W[n].detach().clone().float().requires_grad_(True) for n in names}
    start = {n: W[n].detach().float() for n in names}
    weights = {n: (leaves[n] if n in leaves else W[n].detach().float()) for n in W}
    m = {n: torch.zeros_like(p) for n, p in leaves.items()}
    v = {n: torch.zeros_like(p) for n, p in leaves.items()}
    key = torch.Generator().manual_seed(dropout_seed)
    dropout = float(cfg["model"].get("lora_dropout") or 0.0)
    losses, first, logits = [], None, {h: [] for h in ref.HEADS}
    for s in range(steps):
        raw, draws = batches[s]
        sample = preprocess.process(cfg, raw, draws, True, device)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=key))
        b = sample["rgb"].shape[0]
        grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
        total = 0.0
        for r0 in range(0, b, block):
            r1 = min(b, r0 + block)
            sub = {k: x[r0:r1] for k, x in sample.items() if torch.is_tensor(x)}
            drops = (ref.LoraDropout(cfg, b, seed % 2 ** 63, device, (r0, r1))
                     if dropout else None)
            out = ref.forward(weights, cfg, sub, prec, drops)
            if s == 0:
                for h in ref.HEADS:
                    logits[h].append(out[h].detach().float().cpu())
            loss = sum(F.binary_cross_entropy_with_logits(out[h], sub[f"{h}_heatmap"].float())
                       for h in ref.HEADS) * ((r1 - r0) / b)
            got = torch.autograd.grad(loss, list(leaves.values()))
            for n, g in zip(leaves, got):
                grads[n] += g
            total += float(loss.detach())
            del out, loss, got
        losses.append(total)
        if s == 0:
            first = {n: g.clone() for n, g in grads.items()}
        _adam(leaves, grads, m, v, s + 1, opt)
        if s == 0:
            change1 = {n: float((leaves[n].detach() - start[n]).norm()) for n in names}
    change = {n: float((leaves[n].detach() - start[n]).norm()) for n in names}
    return {"losses": losses, "logits": {h: torch.cat(x) for h, x in logits.items()},
            "grads": first, "change_norms": change, "change_norms_1": change1}
