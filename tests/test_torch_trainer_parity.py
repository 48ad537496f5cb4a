"""The port's Trainer against the JAX package's Trainer, on the CPU.

Both Trainers take the same composed config at the tiny size of
``tests/test_trainer.py`` (SigLIP "tiny" towers, 64 px, dim 64, depth 1,
batch 8 of 16 synthetic samples: 2 epochs of 2 steps), in float32, with
spatial augmentation off and ``lora_dropout`` 0 (the port draws its random
numbers from torch, not JAX), the linear-warmup schedule and gradient clip
1.0. The port's model starts from the JAX Trainer's initial params, through
``convert_bifold_inverse``. Held: every step's loss within 1e-5 relative,
the final trainable weights within 1e-5 absolute, the epoch-2 pixel metrics
within 1e-4 relative (``quantile_prob`` counts heatmap pixels at or below
the target's value, so a 1e-7 heatmap difference can move it by one pixel's
share) with equal decoded actions on the first test batch. The JAX
Trainer's ``last.ckpt`` then loads into the port's Trainer: its weights
bitwise, and its Adam moments and update count. Once without and once with
``optim.accumulate_steps=2`` (optax.MultiSteps).
"""

import json

import jax
import numpy as np
import pytest
import torch

from bifold_tpu.config import Config as JaxConfig
from bifold_tpu.config import compose as jax_compose
from bifold_tpu.trainer import Trainer as JaxTrainer
from bifold_tpu_torch.config import Config, compose
from bifold_tpu_torch.models.convert import convert_bifold_inverse
from bifold_tpu_torch.trainer import Trainer


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads per test: the suite runs several workers at
    once, and torch's default (every core per process) oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-4


def _overrides(run_dir, accumulate):
    return ["train_dataset=synthetic", "test_dataset=null", "model=siglip",
            "train_dataset.n_samples=16", "train_dataset.image_size=64",
            "model.image_size=64", "model.automodel_name=tiny", "model.dim=64",
            "model.depth=1", "model.heads=4", "model.r=2", "epochs=2",
            "eval_epochs=2", "batch_size=8", "test_batch_size=8", "simulator=null",
            f"run_dir={run_dir}", "log_every=1", "processor.spatial_augment=false",
            "model.lora_dropout=0", "precision.compute_dtype=float32",
            "scheduler=linear_warmup", "gradient_clip=1.0",
            f"optim.accumulate_steps={accumulate}"]


def _losses(run_dir):
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    return [r["train/loss"] for r in map(json.loads, lines) if "train/loss" in r]


def _host_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("accumulate", [1, 2], ids=["plain", "accumulate_steps=2"])
def test_trainer_matches_jax(tmp_path, accumulate):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jt = JaxTrainer(JaxConfig(jax_compose(_overrides(jax_dir, accumulate))), run_dir=jax_dir)
    init = convert_bifold_inverse(_host_tree(jt.params))
    jt.prepare_train()
    jt.train()

    pt = Trainer(Config(compose(_overrides(port_dir, accumulate) + ["use_cpu=true"])),
                 run_dir=port_dir)
    pt.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
                             strict=True)
    pt.prepare_train()
    assert pt.optimizer.accumulate_steps == accumulate
    pt.train()
    assert pt.global_step == jt.global_step == 4

    want = _losses(jax_dir)
    got = _losses(port_dir)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    final = convert_bifold_inverse(_host_tree(jt.params))
    trainable = {n for n, p in pt.model.named_parameters() if p.requires_grad}
    assert trainable and {n for n in trainable if "lora_A" in n}
    for n, p in pt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[n], rtol=0,
                                   atol=PARAM_ATOL if n in trainable else 0, err_msg=n)

    _, want_metrics = jt.eval_epoch(1)
    _, got_metrics = pt.eval_epoch(1)
    assert sorted(got_metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        if np.isnan(v):
            assert np.isnan(got_metrics[k]), k
        else:
            np.testing.assert_allclose(got_metrics[k], v, rtol=METRIC_RTOL, err_msg=k)
    want_action = jt.get_action(next(iter(jt.test_dataloader)))
    got_action = pt.get_action(next(iter(pt.test_dataloader)))
    for (name, a), (_, b) in zip(got_action.fields(), want_action.fields()):
        np.testing.assert_array_equal(a, b, err_msg=name)

    # the JAX Trainer's checkpoint into the port's Trainer
    resumed = Trainer(Config(compose(_overrides(tmp_path / "from_jax", accumulate)
                                     + ["use_cpu=true"])), run_dir=tmp_path / "from_jax")
    resumed.prepare_train()
    assert resumed.load_model(path=jt.ckpt_dir / "last.ckpt")
    assert resumed.epoch == 2 and resumed.global_step == 4
    for n, p in resumed.model.named_parameters():
        assert np.array_equal(p.detach().numpy(), final[n]), n
    adam = [s for s in jax.tree_util.tree_leaves(
        jt.opt_state, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"]
    assert len(adam) == 1
    opt = resumed.optimizer
    assert opt.count == int(adam[0].count) == 4 // accumulate
    for key in ("mu", "nu"):
        moments = convert_bifold_inverse(jax.tree_util.tree_map(
            lambda m, p: np.asarray(p) if type(m).__name__ == "MaskedNode" else np.asarray(m),
            getattr(adam[0], key), _host_tree(jt.params),
            is_leaf=lambda x: type(x).__name__ == "MaskedNode"))
        for n, v in zip(opt.names, getattr(opt, key)):
            assert np.array_equal(v.numpy(), moments[n]), (key, n)
