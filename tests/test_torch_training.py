"""The port's train step against the JAX package's, on the CPU.

A tiny SiglipSequential (SigLIP "tiny" towers, 64 px, dim 64, bimanual,
3 context frames, LoRA r8 on q/v, dropout 0) is initialised in JAX (LoRA B
made nonzero so every adapter has a gradient), converted with the port's
``convert_bifold_inverse`` and loaded into the port. One f32 step of
``bce_gaussmap`` + SGD (lr 0.5, gradient clip 1.0) on the same numpy batch
runs through ``bifold_tpu.parallel.make_train_step`` and the port's
``make_train_step``, on the XLA/math path and again on the flash path (the
Pallas kernels in interpret mode against the port's autograd Function over
the plain versions).

Tolerances (both sides sum in f32 in different orders; measured on this
config: loss and heads <= 6e-7 relative, gradient norm 3.5e-7, parameters
6e-8, updates 4.5e-5): loss and per-head terms within 1e-5 relative;
gradient norms within 1e-5 relative; every trainable tensor after the update
within 1e-5 absolute of JAX's, and its update (new - old) within 5e-4 of the
update's norm.

Dropout: keep rate and 1 / (1 - p) scaling, the same masks from the same
generator seed, identity in eval mode, and no draw from the global RNG.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu import parallel as jax_parallel
from bifold_tpu.losses import build_loss as jax_build_loss
from bifold_tpu.models import build_model as jax_build_model
from bifold_tpu.models import trainable_mask as jax_trainable_mask
from bifold_tpu.optim import build_optimizer as jax_build_optimizer
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.models import build_model, precast_frozen, trainable_mask
from bifold_tpu_torch.models.convert import convert_bifold_inverse
from bifold_tpu_torch.models.dropout import Dropout, set_dropout_generator
from bifold_tpu_torch.ops import flash_attention as fa
from bifold_tpu_torch.optim import build_optimizer
from bifold_tpu_torch.parallel import TrainState, make_train_step

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-5
PARAM_ATOL = 1e-5
UPDATE_RTOL = 5e-4

S, T, B = 64, 3, 2
CFG = {"name": "siglip_sequential", "image_size": S, "is_bimanual": True,
       "patch_size": 16, "automodel_name": "tiny", "dim": 64, "lora": True,
       "r": 8, "lora_alpha": 32, "lora_dropout": 0.0, "dropout": 0.0,
       "depth": 2, "heads": 4, "context_length": T, "threshold": 0.01}
LOSS = {"name": "bce_gaussmap", "is_bimanual": True, "mask_pick_heatmap": False}
SGD = {"name": "sgd", "lr": 0.5, "momentum": 0.0, "nesterov": False}
HEADS = ("left_pick", "right_pick", "left_place", "right_place")


def _batch(seed):
    rng = np.random.default_rng(seed)
    batch = {
        "rgb": rng.standard_normal((B, 3, S, S)).astype(np.float32),
        "instruction": rng.integers(0, 30000, (B, 64)).astype(np.int32),
        "rgb_context": rng.standard_normal((B, T, 3, S, S)).astype(np.float32),
        "context_attention_mask": np.array([[1, 1, 1], [1, 0, 0]], np.int32),
    }
    for h in HEADS:
        batch[f"{h}_heatmap"] = rng.random((B, S, S)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_setup():
    model = jax_build_model(CFG)
    batch = _batch(0)
    variables = jax.jit(lambda k: model.init(
        k, {n: jnp.asarray(v) for n, v in batch.items()},
        deterministic=True))(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(1)

    def bump(tree):  # nonzero LoRA B so lora_A gets a gradient too
        return {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32)
                if k == "lora_b" else (bump(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}

    return model, bump(params), batch


def _jax_step(model, params, batch):
    mask = jax_trainable_mask(params, lora=True)
    tx, _ = jax_build_optimizer(dict(SGD), None, max_iters=10, trainable=mask,
                                gradient_clip=1.0)
    step = jax_parallel.make_train_step(model, jax_build_loss(dict(LOSS)), tx,
                                        donate=False, trainable=mask)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = (jparams, tx.init(jparams), {}, jax.random.key(0))
    (new_params, *_), metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (convert_bifold_inverse(jax.tree_util.tree_map(np.asarray, new_params)),
            {k: float(v) for k, v in metrics.items()})


def _port_step(params, batch):
    model = build_model(CFG, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           convert_bifold_inverse(params).items()}, strict=True)
    mask = trainable_mask(model, lora=True)
    train = [p for p in model.parameters() if p.requires_grad]
    opt = build_optimizer(dict(SGD), train, max_iters=10, gradient_clip=1.0)
    step = make_train_step(model, build_loss(dict(LOSS)), opt)
    state, metrics = step(TrainState.create(opt),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1
    return model, mask, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_train_step_matches_jax(jax_setup, backend, monkeypatch):
    if backend == "flash":
        monkeypatch.setenv("BIFOLD_ATTN_BACKEND", "flash")
        monkeypatch.setenv("BIFOLD_FLASH_INTERPRET", "1")
    model, params, batch = jax_setup
    old = convert_bifold_inverse(params)
    jax_new, jax_metrics = _jax_step(model, params, batch)
    launches = sum(fa.LAUNCHES.values())
    tmodel, mask, metrics = _port_step(params, batch)
    assert sum(fa.LAUNCHES.values()) == launches        # plain versions only

    for k in ("loss",) + HEADS:
        np.testing.assert_allclose(metrics[k], jax_metrics[k], rtol=LOSS_RTOL, err_msg=k)
    for k in ("grad_norm", "grad_norm_trainable"):
        np.testing.assert_allclose(metrics[k], jax_metrics[k], rtol=NORM_RTOL, err_msg=k)
    assert jax_metrics["grad_norm"] > 1.0               # the clip was active

    state = tmodel.state_dict()
    trained = [k for k, t in mask.items() if t]
    # LoRA A/B on q/v of 2 + 2 tower layers, 3 learned tokens, the fusion's
    # type embedding and 11 tensors per layer, 10 per decoder head
    assert len(trained) == 2 * 2 * 2 * 2 + 3 + 1 + 2 * 11 + 4 * 10
    for k in mask:
        new = state[k].numpy()
        if not mask[k]:
            np.testing.assert_array_equal(new, old[k], err_msg=k)
            continue
        np.testing.assert_allclose(new, jax_new[k], atol=PARAM_ATOL, err_msg=k)
        d_port, d_jax = new - old[k], jax_new[k] - old[k]
        assert np.abs(d_jax).max() > 0, k
        assert np.linalg.norm(d_port - d_jax) <= UPDATE_RTOL * np.linalg.norm(d_jax), k


def test_trainable_mask_matches_jax(jax_setup):
    """The port freezes exactly the parameters the JAX mask freezes."""
    _, params, _ = jax_setup
    jmask = jax.tree_util.tree_leaves(jax_trainable_mask(params, lora=True))
    n_jax = sum(np.size(p) for p, t in zip(jax.tree_util.tree_leaves(params),
                                           jmask) if t)
    assert 0 < n_jax < sum(np.size(p) for p in jax.tree_util.tree_leaves(params))
    model = build_model(CFG, device="cpu")
    mask = trainable_mask(model, lora=True)
    n_port = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    assert n_port == n_jax
    assert all(p.requires_grad == mask[n] for n, p in model.named_parameters())
    assert not any(mask[n] for n in mask if n.startswith("siglip_model")
                   and "lora_" not in n)


def test_precast_frozen_keeps_trainable_masters():
    model = build_model(CFG, dtype=torch.bfloat16, device="cpu")
    mask = trainable_mask(model, lora=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cast = precast_frozen(model, torch.bfloat16, min_size=1024)
    assert cast and all(not mask[n] for n in cast)
    for n, p in model.named_parameters():
        if n in cast:
            assert p.dtype == torch.bfloat16
            torch.testing.assert_close(p, before[n].to(torch.bfloat16), rtol=0, atol=0)
        else:
            assert p.dtype == torch.float32
            torch.testing.assert_close(p, before[n], rtol=0, atol=0)
    assert precast_frozen(model, torch.float32) == []


def test_dropout_keep_rate_and_scale():
    drop = Dropout(0.25).train()
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.full((400, 500), 2.0)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005   # 200k draws: 5 sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / 0.75))
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros_like(x))


def test_dropout_masks_follow_the_generator_seed():
    """The same seed gives the same masks over a whole model's forward,
    another seed other masks; torch's global RNG is never drawn from."""
    cfg = dict(CFG, lora_dropout=0.3, dropout=0.3)
    model = build_model(cfg, device="cpu").train()
    sample = {k: torch.from_numpy(v) for k, v in _batch(2).items()}

    def forward(seed):
        set_dropout_generator(model, torch.Generator().manual_seed(seed))
        try:
            return model(sample)["left_pick_logits"]
        finally:
            set_dropout_generator(model, None)

    state = torch.random.get_rng_state()
    a, b, c = forward(5), forward(5), forward(6)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    with pytest.raises(RuntimeError, match="generator"):
        model(sample)
    model.eval()
    assert torch.equal(model(sample)["left_pick_logits"],
                       model(sample)["left_pick_logits"])
