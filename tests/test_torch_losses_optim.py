"""The port's losses and optimizers against the JAX package's (optax).

Losses: values and gradients with respect to the model outputs, on numpy-
seeded heatmaps and logits that include saturated probabilities (exactly 0
and 1) and large logits. Values within 1e-6 relative, gradients within
1e-5 relative (f32, same formulas; exp and log1p may differ in the last bit
between XLA and torch, and sums run in another order).

Optimizers: each configuration runs 5 updates on the same fixed gradients
(one with a NaN, to exercise ``skip_nonfinite``) from the same parameters,
through ``bifold_tpu.optim.build_optimizer`` (optax) and the port's
``build_optimizer``; parameters after every step within 1e-6 relative +
1e-7 absolute (f32; the schedule's float32 arithmetic may differ in the last
bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bifold_tpu.losses import build_loss as jax_build_loss
from bifold_tpu.optim import build_optimizer as jax_build_optimizer
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.optim import build_optimizer

RTOL = 1e-6
GRAD_RTOL = 1e-5
HEADS = ("left_pick", "right_pick", "left_place", "right_place")


def _outputs(seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    out, sample = {}, {}
    for h in HEADS:
        logits = rng.normal(scale=4.0, size=(b, s, s)).astype(np.float32)
        logits[0, 0, :4] = [30.0, -30.0, 120.0, -120.0]   # saturated sigmoids
        out[f"{h}_logits"] = logits
        out[f"{h}_heatmap"] = (1 / (1 + np.exp(-logits.astype(np.float64)))).astype(np.float32)
        sample[f"{h}_heatmap"] = rng.random((b, s, s)).astype(np.float32)
        sample[f"{h}_heatmap"][0, 0, :4] = [1.0, 0.0, 0.0, 1.0]
    mask_hm = rng.random((b, s, s)).astype(np.float32)
    mask_hm[0, 0, :3] = [0.0, 1.0, 0.5]                    # p exactly 0 and 1
    out["mask_heatmap"] = mask_hm
    sample["mask"] = (rng.random((b, 1, s, s)) > 0.4).astype(np.float32)
    return out, sample


LOSS_CFGS = [
    {"name": "bce_gaussmap", "is_bimanual": True, "mask_pick_heatmap": False},
    {"name": "bce_gaussmap", "is_bimanual": True, "mask_pick_heatmap": True},
    {"name": "bce_mask"},
    {"name": "dice"},
    {"name": "focal", "alpha": 0.25, "gamma": 2.0},
    {"name": "composed", "loss_names": ["bce_gaussmap", "focal", "dice"],
     "weights": [40, 20, 1], "is_bimanual": True, "mask_pick_heatmap": True},
]


@pytest.mark.parametrize("probabilities", [False, True])
@pytest.mark.parametrize("cfg", LOSS_CFGS, ids=lambda c: c["name"] + (
    "_masked" if c.get("mask_pick_heatmap") else ""))
def test_loss_values_and_grads_match_jax(cfg, probabilities):
    """``probabilities``: drop the logits so bce_gaussmap takes its
    probability path (clamped BCE, gradient through the clipped p)."""
    out, sample = _outputs(0)
    if probabilities:
        out = {k: v for k, v in out.items() if not k.endswith("_logits")}
    jfn, tfn = jax_build_loss(dict(cfg)), build_loss(dict(cfg))

    def jloss(o):
        return jfn(o, {k: jnp.asarray(v) for k, v in sample.items()})

    (jval, jinter), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in out.items()}
    tval, tinter = tfn(tout, {k: torch.from_numpy(v) for k, v in sample.items()})
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    assert sorted(tinter) == sorted(jinter)
    for k in tinter:
        np.testing.assert_allclose(tinter[k].item(), float(jinter[k]), rtol=RTOL, err_msg=k)
    for k, t in tout.items():
        g = np.zeros_like(out[k]) if t.grad is None else t.grad.numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, np.asarray(jgrad[k]), rtol=GRAD_RTOL,
                                   atol=1e-9, err_msg=k)


def test_bce_saturated_probabilities():
    """p = 0 and p = 1: the value uses the -100 clamp, the gradient is
    finite (zero outside [1e-12, 1 - 1e-6])."""
    from bifold_tpu_torch.losses import binary_cross_entropy

    p = torch.tensor([0.0, 1.0, 0.0, 1.0, 0.5], requires_grad=True)
    t = torch.tensor([1.0, 0.0, 0.0, 1.0, 1.0])
    loss = binary_cross_entropy(p, t, reduction="none")
    torch.testing.assert_close(loss[:4], torch.tensor([100.0, 100.0, 0.0, 0.0]))
    loss.sum().backward()
    assert torch.isfinite(p.grad).all()
    assert torch.equal(p.grad[:4], torch.zeros(4))


OPTIM_CASES = [
    ({"name": "adam", "lr": 1e-2, "betas": [0.9, 0.999], "eps": 1e-8,
      "weight_decay": 0}, None, 1.0),
    ({"name": "adam", "lr": 1e-2, "weight_decay": 0.1},
     {"name": "linear_warmup", "warmup_portion": 0.4, "warmup_start_lr": 1e-4,
      "use_cosine_decay": True}, None),
    ({"name": "adamw", "lr": 3e-3, "weight_decay": 0.05},
     {"name": "linear_warmup", "warmup_portion": 0.2, "use_cosine_decay": False},
     0.5),
    ({"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True}, None, 1.0),
    ({"name": "sgd", "lr": 0.1, "skip_nonfinite": 2}, None, 0.7),
]


@pytest.mark.parametrize("optim_cfg,sched_cfg,clip", OPTIM_CASES,
                         ids=["adam_clip", "adam_l2_cosine", "adamw_const",
                              "sgd_nesterov", "sgd_skip_nonfinite"])
def test_optimizer_matches_optax(optim_cfg, sched_cfg, clip):
    rng = np.random.default_rng(7)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(scale=2.0, size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    grads[2]["b"][1] = np.nan                  # a non-finite step
    skip = optim_cfg.get("skip_nonfinite", 0)
    if not skip:
        grads[2]["b"][1] = 0.0

    tx, _ = jax_build_optimizer(dict(optim_cfg), sched_cfg, max_iters=5,
                                gradient_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = build_optimizer(dict(optim_cfg), tp, sched_cfg, max_iters=5,
                          gradient_clip=clip)
    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        for k, t in zip(("a", "b"), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=RTOL,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    if skip:
        assert opt.total_notfinite == 1 and opt.count == 4


def test_optimizer_refuses_what_is_not_ported():
    p = [torch.zeros(2)]
    with pytest.raises(KeyError):
        build_optimizer({"name": "adam", "lr": 1e-3}, p, {"name": "step_decay"})
    with pytest.raises(KeyError):
        build_optimizer({"name": "lamb", "lr": 1e-3}, p)
    with pytest.raises(TypeError):
        build_optimizer({"name": "sgd", "lr": 1e-3, "betas": [0.9, 0.99]}, p)
