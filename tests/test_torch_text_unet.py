"""The port's ``text_unet`` family (TextConditionedUNet) against the JAX
package's, on the CPU.

The CLIP text tower behind ``text_encoder: RN50`` is swapped, in both
packages, for a tiny one with CLIP's vocabulary and 77-token context (2
layers of width 32); the UNet runs at 64 px with features [8, 16, 32],
bimanual. Weights and BatchNorm statistics (made non-trivial: running means
N(0, 0.1), variances in [0.5, 1.5]) are initialised in JAX and converted by
the port.

Held:
- ``convert_text_unet_inverse`` / ``convert_text_unet`` against JAX's (key
  sets and values, bitwise) and a strict load;
- the f32 forward in eval mode (running statistics) within 1e-4 with equal
  decoded actions at the family's threshold 0.01, and in train mode (batch
  statistics) within 1e-4 with the moved running statistics within 1e-6;
- one f32 train step (bce_gaussmap, SGD 0.5, clip 1.0) against
  ``bifold_tpu.parallel.make_train_step(has_batch_stats=True)``: loss and
  gradient norm within 1e-5 relative, trainable tensors within 1e-5, the
  frozen text tower untouched, ``batch_stats`` within 1e-6; and a step that
  ``skip_nonfinite`` skips (a NaN target) keeps the weights but moves the
  statistics as JAX's does;
- serving: a JAX ``save_checkpoint`` file with ``batch_stats`` served by
  the port's ``from_checkpoint`` as JAX's ``ServingModel`` serves the same
  weights (heatmaps within 1e-4, equal actions), and the port's artifact
  (``export`` / ``load_exported``, BatchNorm buffers included) bitwise
  equal to the live server;
- int8 decisions, payloads and scales against JAX's ``quantize_weights``,
  tiny and (decisions only, from shapes) at the shipped full size;
- the port's Trainer against the JAX Trainer over two f32 steps (losses,
  weights and statistics), the JAX Trainer's checkpoint resumed in the
  port's, and the port's checkpoint (``extra_vars["batch_stats"]``) resumed
  in the JAX Trainer's.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu import parallel as jax_parallel
from bifold_tpu.config import Config as JaxConfig
from bifold_tpu.config import compose as jax_compose
from bifold_tpu.losses import build_loss as jax_build_loss
from bifold_tpu.models import build_model as jax_build_model
from bifold_tpu.models import decode_action as jax_decode_action
from bifold_tpu.models import trainable_mask as jax_trainable_mask
from bifold_tpu.models.backbones import clip_backbone as jcb
from bifold_tpu.models.convert import convert_text_unet as jax_convert
from bifold_tpu.models.convert import convert_text_unet_inverse as jax_inverse
from bifold_tpu.optim import build_optimizer as jax_build_optimizer
from bifold_tpu.data.processor import Processor as JaxProcessor
from bifold_tpu.serving import ServingModel as JaxServingModel
from bifold_tpu.serving import quantize_weights as jax_quantize
from bifold_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from bifold_tpu.trainer import Trainer as JaxTrainer
from bifold_tpu_torch.config import Config, compose
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.models import build_model, decode_action, trainable_mask
from bifold_tpu_torch.models.backbones import clip_backbone as pcb
from bifold_tpu_torch.models.convert import (convert_text_unet,
                                             convert_text_unet_inverse)
from bifold_tpu_torch.optim import build_optimizer
from bifold_tpu_torch.parallel import TrainState, make_train_step
from bifold_tpu_torch.serving import QUANT_TAG, ServingModel
from bifold_tpu_torch.trainer import Trainer
from test_torch_rgb_clip import PROC_CFG, check_int8_decisions, clip_ids, observation

F32_TOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
STATS_ATOL = 1e-6
# The biases of the convs that feed a BatchNorm (each decoder block's conv1
# and conv2) have an exact gradient of 0 in train mode: the batch mean
# removes them, and what either side computes is f32 rounding noise.
# test_exact_zero_gradients_are_the_pre_bn_biases finds them by a rule on
# the JAX gradient (below NOISE_GRAD_REL of its largest entry; the measured
# gap is ~1e-7 against >= 6e-4) and holds that set equal to this pattern.
# One SGD step moves them by lr * noise, inside PARAM_ATOL. Adam makes such
# noise into steps of up to lr (1e-4) in either sign, so after the Trainer's
# two Adam steps they are held to that bound; every other tensor to
# PARAM_ATOL.
PRE_BN_BIAS = re.compile(r"^decoder\.\d+\.conv[12]\.bias$")
NOISE_GRAD_REL = 2.0 ** -16
ADAM_NOISE_ATOL = 2 * 2 * 1e-4 + PARAM_ATOL     # two steps, each side
# the decoder BatchNorms' running means take in those biases at weight 0.01
# per step
TRAINER_STATS_ATOL = STATS_ATOL + 0.01 * 2 * ADAM_NOISE_ATOL

S, B = 64, 2
TINY_TEXT = dict(text_width=32, text_layers=2, text_heads=4, context_length=77,
                 vocab_size=49408, embed_dim=64)
CFG = {"name": "text_unet", "image_size": S, "is_bimanual": True,
       "requires_graph": False, "text_encoder": "RN50", "features": [8, 16, 32],
       "threshold": 0.01}
LOSS = {"name": "bce_gaussmap", "is_bimanual": True, "mask_pick_heatmap": False}
SGD = {"name": "sgd", "lr": 0.5, "momentum": 0.0, "nesterov": False}
HEADS = ("left_pick", "right_pick", "left_place", "right_place")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads per test: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def tiny_text():
    """RN50's text tower as the tiny one in both packages, for this module."""
    saved = jcb.CLIP_TEXT_CONFIGS["RN50"], pcb.CLIP_TEXT_CONFIGS["RN50"]
    jcb.CLIP_TEXT_CONFIGS["RN50"] = jcb.ClipConfig(**TINY_TEXT)
    pcb.CLIP_TEXT_CONFIGS["RN50"] = pcb.ClipConfig(**TINY_TEXT)
    yield
    jcb.CLIP_TEXT_CONFIGS["RN50"], pcb.CLIP_TEXT_CONFIGS["RN50"] = saved


def _batch(seed):
    rng = np.random.default_rng(seed)
    batch = {"depth": (1.0 + rng.standard_normal((B, 1, S, S))).astype(np.float32),
             "instruction": clip_ids(rng, B),
             "mask": (rng.random((B, 1, S, S)) > 0.4).astype(np.float32)}
    for h in HEADS:
        batch[f"{h}_heatmap"] = rng.random((B, S, S)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_setup(tiny_text):
    model = jax_build_model(CFG)
    batch = _batch(0)
    variables = jax.jit(lambda k: model.init(k, _jnp(batch), deterministic=True))(
        jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"])
    for tree in jax.tree_util.tree_leaves(stats, is_leaf=lambda t: "var" in t):
        tree["var"] = rng.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32)
    return model, params, stats, batch


def _port(params, stats):
    model = build_model(CFG, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           convert_text_unet_inverse(params, stats).items()}, strict=True)
    return model


def _stats_of(model):
    return convert_text_unet({k: v.detach() for k, v in model.state_dict().items()})[1]


def _close_trees(got, want, atol, what):
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(want)], what
    for (path, a), (_, b) in zip(flat(got), flat(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_converters_match_jax(jax_setup):
    _, params, stats, _ = jax_setup
    state = convert_text_unet_inverse(params, stats)
    want = jax_inverse(params, stats)
    assert sorted(state) == sorted(want)
    assert "decoder.1.convt.weight" in state and "encoder.2.4.running_var" in state
    for k in want:
        np.testing.assert_array_equal(state[k], want[k], err_msg=k)
    port_state = {k: v.detach() for k, v in _port(params, stats).state_dict().items()}
    assert not [k for k in port_state if "num_batches_tracked" in k]
    got = convert_text_unet(port_state)
    ref = jax_convert({k: v.numpy() for k, v in port_state.items()})
    for a, b, what in zip(got, ref, ("params", "batch_stats")):
        _close_trees(a, b, 0, what)


def test_forward_eval_and_train_match_jax(jax_setup):
    model, params, stats, batch = jax_setup
    jb, tb = _jnp(batch), _torch(batch)
    want = model.apply({"params": params, "batch_stats": stats}, jb, deterministic=True)
    port = _port(params, stats)
    with torch.no_grad():
        got = port(tb)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=F32_TOL,
                                   err_msg=k)
    ja = jax_decode_action(want, jb, is_bimanual=True, threshold=0.01)
    ta = decode_action(got, tb, is_bimanual=True, threshold=port.threshold)
    for k in HEADS:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=k)

    want, moved = model.apply({"params": params, "batch_stats": stats}, jb,
                              deterministic=False, mutable=["batch_stats"])
    with torch.no_grad():
        got = port.train()(tb)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=F32_TOL,
                                   err_msg=k)
    _close_trees(_stats_of(port), moved["batch_stats"], STATS_ATOL, "batch_stats")


def _jax_step(model, params, stats, batch, optim):
    mask = jax_trainable_mask(params, lora=False)
    tx, _ = jax_build_optimizer(dict(optim), None, max_iters=10, trainable=mask,
                                gradient_clip=1.0)
    step = jax_parallel.make_train_step(model, jax_build_loss(dict(LOSS)), tx,
                                        has_batch_stats=True, donate=False,
                                        trainable=mask)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = (jparams, tx.init(jparams), {"batch_stats": stats}, jax.random.key(0))
    (new_params, _, extra, _), metrics = step(state, _jnp(batch))
    host = jax.tree_util.tree_map(np.asarray, (new_params, extra["batch_stats"]))
    return host, {k: float(v) for k, v in metrics.items()}


def _port_step(params, stats, batch, optim):
    port = _port(params, stats)
    mask = trainable_mask(port, lora=False)
    opt = build_optimizer(dict(optim), [p for p in port.parameters() if p.requires_grad],
                          max_iters=10, gradient_clip=1.0)
    _, metrics = make_train_step(port, build_loss(dict(LOSS)), opt)(
        TrainState.create(opt), _torch(batch))
    return port, mask, {k: float(v) for k, v in metrics.items()}


def test_train_step_matches_jax(jax_setup):
    model, params, stats, batch = jax_setup
    (jparams, jstats), jmetrics = _jax_step(model, params, stats, batch, SGD)
    port, mask, metrics = _port_step(params, stats, batch, SGD)
    for k in ("loss", "grad_norm") + HEADS:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL, err_msg=k)
    assert not any(mask[n] for n in mask if n.startswith("clip_encoder."))
    old, new = convert_text_unet_inverse(params, stats), jax_inverse(jparams, jstats)
    state = port.state_dict()
    for n, trained in mask.items():
        if trained:
            np.testing.assert_allclose(state[n].numpy(), new[n], atol=PARAM_ATOL,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(state[n].numpy(), old[n], err_msg=n)
    _close_trees(_stats_of(port), jstats, STATS_ATOL, "batch_stats")
    assert np.abs(jstats["enc0_bn0"]["mean"] - stats["enc0_bn0"]["mean"]).max() > 0


def _noise_gradient_leaves(model, params, stats, batch):
    """The trainable tensors (port names) whose JAX train-mode gradient is
    rounding noise: its largest entry below NOISE_GRAD_REL of the largest
    entry over the whole gradient."""
    loss = jax_build_loss(dict(LOSS))

    def f(p):
        out, _ = model.apply({"params": p, "batch_stats": stats}, _jnp(batch),
                             deterministic=False, mutable=["batch_stats"])
        return loss(out, _jnp(batch))[0]

    grads = jax.tree_util.tree_map(np.asarray, jax.grad(f)(params))
    by_name = jax_inverse(grads, stats)
    top = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(grads))
    mask = trainable_mask(_port(params, stats), lora=False)
    return {n for n, trained in mask.items()
            if trained and np.abs(by_name[n]).max() < NOISE_GRAD_REL * top}


def test_exact_zero_gradients_are_the_pre_bn_biases(jax_setup):
    """The leaves exempt from PARAM_ATOL after Adam are chosen by name; the
    rule on JAX's gradient must pick exactly those."""
    model, params, stats, batch = jax_setup
    noise = _noise_gradient_leaves(model, params, stats, batch)
    names = convert_text_unet_inverse(params, stats)
    assert noise == {n for n in names if PRE_BN_BIAS.match(n)}
    assert len(noise) == 2 * (len(CFG["features"]) - 1)


def test_skipped_step_moves_the_statistics_as_jax(jax_setup):
    """A NaN target makes every gradient non-finite: both optimizers skip
    the update, and both models' running statistics move all the same."""
    model, params, stats, batch = jax_setup
    batch = dict(batch, left_pick_heatmap=np.full_like(batch["left_pick_heatmap"], np.nan))
    optim = dict(SGD, skip_nonfinite=3)
    (jparams, jstats), _ = _jax_step(model, params, stats, batch, optim)
    port, mask, metrics = _port_step(params, stats, batch, optim)
    assert not np.isfinite(metrics["loss"])
    state, old = port.state_dict(), convert_text_unet_inverse(params, stats)
    for n in mask:
        np.testing.assert_array_equal(state[n].numpy(), old[n], err_msg=n)
    _close_trees(jparams, params, 0, "params")
    _close_trees(_stats_of(port), jstats, STATS_ATOL, "batch_stats")
    assert np.abs(jstats["dec0"]["bn1"]["var"] - stats["dec0"]["bn1"]["var"]).max() > 0


def test_checkpoint_and_artifact_serve_as_jax(jax_setup, tmp_path):
    model, params, stats, _ = jax_setup
    path = tmp_path / "last.ckpt"
    jax_save_checkpoint(path, params=params, opt_state=None,
                        extra_vars={"batch_stats": stats}, epoch=1)
    cfg = {"model": CFG, "processor": dict(PROC_CFG, text_encoder="RN50"),
           "precision": {"compute_dtype": "float32"}}
    ours = ServingModel.from_checkpoint(path, cfg, device="cpu")
    theirs = JaxServingModel(model, {"params": params, "batch_stats": stats},
                             JaxProcessor(cfg["processor"], partition="test"),
                             threshold=0.01)
    rng = np.random.default_rng(4)
    obs = dict(observation(rng), instruction="fold the towel in half")
    (ja, jr), (ta, tr) = (srv.predict(**obs, return_raw_output=True)
                          for srv in (theirs, ours))
    for k in tr:
        np.testing.assert_allclose(tr[k], np.asarray(jr[k]), atol=F32_TOL, err_msg=k)
    for f in HEADS:
        np.testing.assert_array_equal(getattr(ta, f), np.asarray(getattr(ja, f)), err_msg=f)
    art = ours.export(tmp_path / "a.pt", **obs, batch=2)
    loaded = ServingModel.load_exported(art, device="cpu")
    # the artifact pads to its 2 rows; the live server at the same pool size
    # (a convolution's CPU algorithm may depend on the batch)
    la, lr = loaded.predict(**obs, return_raw_output=True)
    pa, pr = ours.predict_batch([obs], pad_to=2, return_raw_output=True)
    assert all(np.array_equal(lr[k], pr[k]) for k in pr)
    assert all(np.array_equal(getattr(la, f), getattr(pa, f)) for f in HEADS)
    buffers = dict(loaded.server.model.named_buffers())
    np.testing.assert_array_equal(buffers["decoder.0.bn1.running_var"].numpy(),
                                  stats["dec0"]["bn1"]["var"])


def _unet_flags_inverse(stats):
    return lambda tree: convert_text_unet_inverse(tree, stats)


@pytest.mark.parametrize("min_size", [4096, 1024])
def test_int8_matches_jax(jax_setup, min_size):
    _, params, stats, _ = jax_setup
    qtree = jax_quantize({"params": params}, min_size=min_size)["params"]
    state = convert_text_unet_inverse(params, stats)
    weights = {n: torch.from_numpy(np.array(state[n])) for n, _ in
               _port(params, stats).named_parameters()}
    got, want = check_int8_decisions(weights, qtree, _unet_flags_inverse(stats), min_size)
    assert ("decoder.0.convt.weight" in want) == (min_size <= 2048)   # 32 x 16 x 2 x 2
    deq = jax.tree_util.tree_map(np.asarray, qtree)

    def split(node, which):
        if isinstance(node, dict) and "__int8_q__" in node:
            q = np.asarray(node["__int8_q__"])
            return q if which == "q" else np.broadcast_to(np.asarray(node["scale"]), q.shape)
        if isinstance(node, dict):
            return {k: split(v, which) for k, v in node.items()}
        return np.zeros(np.shape(node), np.int8 if which == "q" else np.float32)

    qs, scales = (convert_text_unet_inverse(split(deq, w), stats) for w in ("q", "scale"))
    for k in want:
        np.testing.assert_array_equal(got[k][QUANT_TAG].numpy(), qs[k], err_msg=k)
        np.testing.assert_array_equal(np.broadcast_to(got[k]["scale"].numpy(),
                                                      qs[k].shape), scales[k], err_msg=k)


def test_int8_decisions_at_full_size():
    """The shipped text_unet (RN50's text tower, features up to 1024, 384
    px): the same tensors quantized as JAX's rule picks, from shapes."""
    full = dict(CFG, image_size=384, features=[64, 128, 256, 512, 1024])
    saved = jcb.CLIP_TEXT_CONFIGS["RN50"], pcb.CLIP_TEXT_CONFIGS["RN50"]
    jcb.CLIP_TEXT_CONFIGS["RN50"] = jcb.ClipConfig(embed_dim=1024)
    pcb.CLIP_TEXT_CONFIGS["RN50"] = pcb.ClipConfig(embed_dim=1024)
    try:
        jmodel = jax_build_model(full)
        sample = {"depth": jax.ShapeDtypeStruct((1, 1, 384, 384), jnp.float32),
                  "instruction": jax.ShapeDtypeStruct((1, 77), jnp.int32)}
        shapes = jax.eval_shape(lambda s: jmodel.init(jax.random.key(0), s), sample)
        qtree = jax.eval_shape(lambda p: jax_quantize({"params": p})["params"],
                               shapes["params"])
        from bifold_tpu_torch.models.bifold_models import TextConditionedUNet
        with torch.device("meta"):
            port = TextConditionedUNet(384, True, features=(64, 128, 256, 512, 1024))
    finally:
        jcb.CLIP_TEXT_CONFIGS["RN50"], pcb.CLIP_TEXT_CONFIGS["RN50"] = saved
    stats = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                   shapes["batch_stats"])
    _, want = check_int8_decisions({n: p.detach() for n, p in port.named_parameters()},
                                   qtree, _unet_flags_inverse(stats), 2 ** 16)
    assert "clip_encoder.text_projection" in want and "decoder.0.convt.weight" in want
    assert "clip_encoder.positional_embedding" not in want
    assert "clip_encoder.token_embedding.weight" not in want


def _overrides(run_dir):
    return ["train_dataset=synthetic", "test_dataset=null", "model=text_unet",
            "train_dataset.n_samples=16", "train_dataset.image_size=64",
            "train_dataset.is_bimanual=true", "model.features=[8,16,32]",
            "epochs=1", "eval_epochs=1", "batch_size=8", "test_batch_size=8",
            "simulator=null", f"run_dir={run_dir}", "log_every=1",
            "processor.spatial_augment=false", "precision.compute_dtype=float32",
            "gradient_clip=1.0"]


def _losses(run_dir):
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    return [r["train/loss"] for r in map(json.loads, lines) if "train/loss" in r]


def test_trainer_matches_jax_and_checkpoints_cross(tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jt = JaxTrainer(JaxConfig(jax_compose(_overrides(jax_dir))), run_dir=jax_dir)
    host = jax.tree_util.tree_map(np.asarray, (jt.params, jt.extra_vars["batch_stats"]))
    jt.prepare_train()
    jt.train()
    pt = Trainer(Config(compose(_overrides(port_dir) + ["use_cpu=true"])),
                 run_dir=port_dir)
    pt.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                              convert_text_unet_inverse(*host).items()}, strict=True)
    pt.prepare_train()
    pt.train()
    assert pt.global_step == jt.global_step == 2
    np.testing.assert_allclose(_losses(port_dir), _losses(jax_dir), rtol=LOSS_RTOL)
    final = jax.tree_util.tree_map(np.asarray, (jt.params, jt.extra_vars["batch_stats"]))
    want = convert_text_unet_inverse(*final)
    for n, p in pt.model.named_parameters():
        atol = ((ADAM_NOISE_ATOL if PRE_BN_BIAS.match(n) else PARAM_ATOL)
                if p.requires_grad else 0)
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=atol,
                                   err_msg=n)
    _close_trees(_stats_of(pt.model), final[1], TRAINER_STATS_ATOL, "batch_stats")
    a = jt.get_action(next(iter(jt.test_dataloader)))
    b = pt.get_action(next(iter(pt.test_dataloader)))
    for (name, x), (_, y) in zip(b.fields(), a.fields()):
        np.testing.assert_array_equal(x, y, err_msg=name)

    # the JAX Trainer's last.ckpt into the port's Trainer ...
    resumed = Trainer(Config(compose(_overrides(tmp_path / "r") + ["use_cpu=true"])),
                      run_dir=tmp_path / "r")
    resumed.prepare_train()
    assert resumed.load_model(path=jt.ckpt_dir / "last.ckpt")
    got = resumed.model.state_dict()
    for n, v in want.items():
        assert np.array_equal(got[n].float().numpy(), np.asarray(v, np.float32)), n
    # ... and the port's last.ckpt into the JAX Trainer (its weights and
    # statistics: JAX's optimizer cannot take the port's opt_state)
    jt2 = JaxTrainer(JaxConfig(jax_compose(_overrides(tmp_path / "j2"))),
                     run_dir=tmp_path / "j2")
    assert jt2.load_model(path=pt.ckpt_dir / "last.ckpt")
    mine = convert_text_unet({k: v.detach().float() for k, v in pt.model.state_dict().items()})
    _close_trees(jax.tree_util.tree_map(np.asarray, jt2.params), mine[0], 0, "params")
    _close_trees(jax.tree_util.tree_map(np.asarray, jt2.extra_vars["batch_stats"]),
                 mine[1], 0, "batch_stats")


def test_t5_text_encoder_raises():
    """A text encoder that is neither a CLIP name nor a T5 one raises as
    JAX's resolve_t5_config does (the T5 branch itself is ported:
    tests/test_torch_t5.py)."""
    with pytest.raises(ValueError, match="neither a CLIP model"):
        build_model(dict(CFG, text_encoder="definitely-not-a-model"), device="cpu")
    assert hasattr(build_model(dict(CFG, text_encoder="t5-small"), device="cpu"),
                   "text_encoder")
