"""Rematerialization (``remat``) and the variants through the port's
Trainer, on the CPU.

- With dropout > 0 (the fusion's ``dropout`` and the towers' LoRA dropout),
  one train step with every block recomputed in the backward gives the
  loss and the gradients the same step without remat gives, from the same
  draws: the checkpointed blocks replay their dropout generator's state in
  the recompute. In the default, ``pallas`` and ``fused`` LayerNorm modes,
  and with MoE FFNs (whose load-balance losses come out of the
  checkpointed blocks);
- with remat on both sides (dropout 0), the port's step equals JAX's
  (``nn.remat`` per block) within 1e-5;
- the Trainer: ``precision.remat: true`` builds every tower and fusion
  stack with remat (the JAX Trainer passes the same override) and trains;
  ``model.moe_experts`` trains with the load-balance term, logged as
  ``train/moe_load_balance`` as the JAX Trainer logs it, and JAX reads
  the port's MoE checkpoint; the transformer decoder and
  cross-attention train through ``python -m bifold_tpu_torch``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.config import Config as JaxConfig
from bifold_tpu.config import compose as jax_compose
from bifold_tpu.trainer import Trainer as JaxTrainer
from bifold_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from bifold_tpu_torch import __main__ as cli
from bifold_tpu_torch.config import Config, compose
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.models import build_model, trainable_mask
from bifold_tpu_torch.models.convert import convert_bifold_inverse
from bifold_tpu_torch.models.layers import Transformer
from bifold_tpu_torch.optim import build_optimizer
from bifold_tpu_torch.parallel import TrainState, make_train_step
from bifold_tpu_torch.trainer import Trainer
from test_torch_training import CFG as BASE, LOSS, SGD, _batch
from test_torch_variants import _jax_step

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
# the same step computed twice from the same weights, batch and draws;
# recomputation runs the same kernels on the same values
SAME_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _grads(cfg, state, batch, remat, aux_weight=0.0, seed=7):
    model = build_model(cfg, device="cpu", remat=remat)
    model.load_state_dict(state)
    trainable_mask(model, lora=True)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    captured = {}
    opt = build_optimizer(dict(SGD), [p for _, p in named], max_iters=10,
                          gradient_clip=1.0)
    real = opt.step

    def keep(grads):
        captured.update({n: g.clone() for (n, _), g in zip(named, grads)})
        return real(grads)

    opt.step = keep
    step = make_train_step(model, build_loss(dict(LOSS)), opt, moe_aux_weight=aux_weight)
    _, metrics = step(TrainState.create(opt, seed=seed),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    return model, captured, metrics


@pytest.mark.parametrize("mode, extra", [
    ("", {}), ("pallas", {}), ("fused", {}),
    ("", {"moe_experts": 4, "moe_aux_weight": 0.01}),
    ("", {"pick_place_model": "pick_place_transdecoder"})],
    ids=["default", "pallas", "fused", "moe", "transdecoder"])
def test_remat_gradients_equal_with_dropout(mode, extra, monkeypatch):
    if mode:
        monkeypatch.setenv("BIFOLD_LN_KERNEL", mode)
    cfg = {**BASE, **extra, "dropout": 0.1, "lora_dropout": 0.1}
    state = build_model(cfg, device="cpu", seed=3).state_dict()
    batch = _batch(1)
    aux_weight = cfg.get("moe_aux_weight", 0.0) if cfg.get("moe_experts") else 0.0
    plain, g0, m0 = _grads(cfg, state, batch, False, aux_weight)
    remat, g1, m1 = _grads(cfg, state, batch, True, aux_weight)
    # every tower and fusion stack, never a transformer decoder's (as in JAX)
    stacks = {n: m.remat for n, m in remat.named_modules() if isinstance(m, Transformer)}
    assert stacks == {n: not n.endswith("_decoder.blocks") for n in stacks}
    assert not any(m.remat for m in plain.modules() if isinstance(m, Transformer))
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=SAME_RTOL, err_msg=k)
    if extra.get("moe_experts"):
        assert "moe_load_balance" in m0
    assert sorted(g1) == sorted(g0)
    nonzero = 0
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=SAME_RTOL,
                                   atol=1e-9, err_msg=n)
        nonzero += bool(g0[n].abs().max() > 0)
    assert nonzero > len(g0) // 2
    # the dropout draws were live: other draws give another loss
    _, _, other = _grads(cfg, state, batch, False, aux_weight, seed=8)
    assert float(other["loss"]) != float(m0["loss"])


def test_remat_matches_jax():
    """remat on both sides, dropout 0: the step equals JAX's."""
    from bifold_tpu.models import build_model as jax_build_model

    cfg = dict(BASE)
    jmodel = jax_build_model(cfg, remat=True)
    batch = _batch(2)
    variables = jax.jit(lambda k: jmodel.init(
        k, {n: jnp.asarray(v) for n, v in batch.items()},
        deterministic=True))(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    jax_new, jax_metrics = _jax_step(jmodel, params, batch, 0.0)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in convert_bifold_inverse(params).items()}
    model, _, metrics = _grads(cfg, state, batch, True)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), jax_metrics[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    for n, p in model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(), jax_new[n],
                                       atol=PARAM_ATOL, err_msg=n)


TINY = ("train_dataset=synthetic", "test_dataset=null",
        "train_dataset.n_samples=16", "train_dataset.image_size=64",
        "train_dataset.max_context_length=2",
        "model.image_size=64", "model.automodel_name=tiny", "model.dim=64",
        "model.depth=1", "model.heads=4", "model.r=2", "epochs=1", "eval_epochs=1",
        "batch_size=8", "test_batch_size=8", "simulator=null", "log_every=1",
        "processor.spatial_augment=false", "precision.compute_dtype=float32")


def _logged(run_dir, key):
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    return [r[key] for r in map(json.loads, lines) if key in r]


def test_trainer_remat(tmp_path):
    cfg = compose(["model=siglip_sequential", *TINY, "precision.remat=true",
                   "model.dropout=0.1", f"run_dir={tmp_path}", "use_cpu=true"])
    trainer = Trainer(Config(cfg), run_dir=tmp_path)
    stacks = [m for m in trainer.model.modules() if isinstance(m, Transformer)]
    assert len(stacks) == 3 and all(m.remat for m in stacks)   # 2 towers, fusion
    trainer.prepare_train()
    trainer.train()
    assert trainer.global_step == 2
    assert all(np.isfinite(_logged(tmp_path, "train/loss")))


# argmax routing: a token whose two best experts are within the packages'
# f32 rounding of each other (the smallest top-2 router gap in this run is
# 3.5e-5) can go to another expert. One such first choice moves the
# load-balance term by E / T x (P_b - P_a), about 1e-4 here (4 experts, 928
# tokens), and the weights and routing of the next steps with it (1e-2 at
# the second step here); the same steps on the same inputs agree within
# 1e-5 (test_torch_variants.py). In this run the first step routes every
# token alike on both sides (router probabilities within 9e-8).
ROUTED_RTOL = 1e-3


def test_trainer_moe_against_jax(tmp_path):
    """Two f32 steps of the MoE variant in both Trainers from the same
    weights: the first step's loss and load-balance term, the term logged
    at every step by both, and the port's checkpoint read by JAX's
    ``load_checkpoint`` (the MoE leaves in JAX's tree)."""
    extra = ("model=siglip_sequential", "model.moe_experts=4", "model.lora_dropout=0.0",
             "optim=sgd", "optim.lr=0.05")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jt = JaxTrainer(JaxConfig(jax_compose([*extra, *TINY, f"run_dir={jax_dir}"])),
                    run_dir=jax_dir)
    init = convert_bifold_inverse(jax.tree_util.tree_map(np.asarray, jt.params))
    jt.prepare_train()
    jt.train()
    pt = Trainer(Config(compose([*extra, *TINY, f"run_dir={port_dir}", "use_cpu=true"])),
                 run_dir=port_dir)
    pt.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
                             strict=True)
    pt.prepare_train()
    pt.train()
    assert pt.global_step == jt.global_step == 2
    got_aux = _logged(port_dir, "train/moe_load_balance")
    want_aux = _logged(jax_dir, "train/moe_load_balance")
    assert len(got_aux) == len(want_aux) == 2 and np.isfinite(got_aux).all()
    # The JAX Trainer keeps the init pass's sown `moe_losses` among its extra
    # variables and hands them to every step, whose sow appends to them: its
    # logged term, and the term in its loss, is the mean of the init pass's
    # terms and the step's own. The port's step, as JAX's make_train_step
    # given the parameters alone, takes the step's own. Recover JAX's own
    # term from the stale values, and its loss with that term.
    stale = [np.asarray(v, np.float64)
             for v in jax.tree_util.tree_leaves(jt.extra_vars["moe_losses"])]
    n = sum(v.size for v in stale)
    own = 2 * want_aux[0] - sum(float(v.sum()) for v in stale) / n
    np.testing.assert_allclose(got_aux[0], own, rtol=ROUTED_RTOL)
    got, want = _logged(port_dir, "train/loss"), _logged(jax_dir, "train/loss")
    weight = float(pt.model.moe_aux_weight)
    np.testing.assert_allclose(got[0], want[0] + weight * (own - want_aux[0]),
                               rtol=LOSS_RTOL)
    # the port's checkpoint as JAX reads it: the MoE leaves in JAX's tree
    payload = jax_load_checkpoint(port_dir / "checkpoints" / "best.ckpt")
    assert payload["step"] == 2
    block = payload["params"]["pick_place"]["fusion"]["transformer_encoder"]["block_0"]
    assert np.shape(block["mlp"]["w1"]) == (4, 64, 256)
    final = {n: p.detach().numpy() for n, p in pt.model.named_parameters()}
    for k, v in convert_bifold_inverse(payload["params"]).items():
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      final[k].astype(np.float32), err_msg=k)


@pytest.mark.parametrize("variant", ["model.pick_place_model=pick_place_transdecoder",
                                     "model.fusion_model=crossattention"])
def test_cli_trains_variant(tmp_path, variant):
    overrides = ["model=siglip_sequential", variant, *TINY, f"run_dir={tmp_path}",
                 "use_cpu=true"]
    assert cli.main(overrides) == 0
    run = tmp_path / cli.run_dir_name(cli.override_dirname(overrides))
    assert (run / "checkpoints" / "last.ckpt").exists()
    assert all(np.isfinite(_logged(run, "train/loss")))
