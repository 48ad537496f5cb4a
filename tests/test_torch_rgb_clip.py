"""The port's ``rgb_clip`` family (RGBOnly) against the JAX package's, on the
CPU.

The CLIP model behind ``text_encoder: ViT-B/16`` is swapped, in both
packages, for a tiny one with CLIP's vocabulary and 77-token context (so
that the CLIP BPE ids fit it): 64 px, 16 px patches, a 2-layer width-64
vision tower, a 2-layer width-32 text tower. The fusion runs at the text
width with one head, so at head dim 32 as the shipped model's 16 heads of
512 do. Weights are initialised in JAX and converted by the port.

Held:
- the converters against JAX's ``convert_bifold_inverse`` /
  ``convert_bifold`` (equal key sets and values), and a strict load;
- the f32 forward within 1e-4 with equal decoded actions, and both
  packages' ``ServingModel`` on the same raw observations (the CLIP BPE
  ids, CLIP's normalisation, 224 px resize): heatmaps within 1e-4, equal
  actions;
- one f32 train step (bce_gaussmap, SGD 0.5, clip 1.0) against
  ``bifold_tpu.parallel.make_train_step``: loss and gradient norm within
  1e-5 relative, every trainable tensor after the step within 1e-5, frozen
  towers untouched; on the XLA path and on the flash path (the Pallas
  kernels in interpret mode against the port's autograd Function);
- int8 decisions, payloads and scales against JAX's ``quantize_weights``,
  tiny and (decisions only, from shapes) at the shipped full size;
- the port's Trainer against the JAX Trainer over two f32 steps (losses
  within 1e-5 relative, trainable weights within 1e-5), and the JAX
  Trainer's checkpoint resumed in the port's;
- the other heads and fusions (``pick_place_transdecoder``,
  ``crossattention``): converters both ways, a strict load, the f32
  forward within 1e-5 with equal actions and one f32 train step within
  1e-5 of JAX's.
"""

import json

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
from bifold_tpu.models.convert import convert_bifold as jax_convert_bifold
from bifold_tpu.models.convert import convert_bifold_inverse as jax_inverse
from bifold_tpu.optim import build_optimizer as jax_build_optimizer
from bifold_tpu.data.processor import Processor as JaxProcessor
from bifold_tpu.serving import ServingModel as JaxServingModel
from bifold_tpu.serving import _QUANT_TAG as JAX_QUANT_TAG
from bifold_tpu.serving import quantize_weights as jax_quantize
from bifold_tpu.trainer import Trainer as JaxTrainer
from bifold_tpu_torch.config import Config, compose
from bifold_tpu_torch.data.processor import Processor
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.models import build_model, decode_action, trainable_mask
from bifold_tpu_torch.models.backbones import clip_backbone as pcb
from bifold_tpu_torch.models.convert import convert_bifold, convert_bifold_inverse
from bifold_tpu_torch.ops import flash_attention as fa
from bifold_tpu_torch.optim import build_optimizer
from bifold_tpu_torch.parallel import TrainState, make_train_step
from bifold_tpu_torch.serving import QUANT_TAG, ServingModel, quantize_weights
from bifold_tpu_torch.trainer import Trainer

F32_TOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5

S, B = 64, 2
TINY_CLIP = dict(image_size=S, patch_size=16, vision_width=64, vision_layers=2,
                 vision_heads=4, text_width=32, text_layers=2, text_heads=4,
                 context_length=77, vocab_size=49408, embed_dim=32)
CFG = {"name": "rgb_clip", "image_size": S, "is_bimanual": True, "patch_size": 16,
       "text_encoder": "ViT-B/16", "depth": 2, "heads": 1, "mlp_ratio": 4,
       "dropout": 0.0, "text_dropout": 0.0, "rgb_dropout": 0.0,
       "pick_place_model": "pick_place_convdecoder",
       "fusion_model": "concat_transformer", "requires_graph": False}
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
def tiny_clip():
    """ViT-B/16 as the tiny CLIP in both packages, for this module."""
    saved = jcb.CLIP_CONFIGS["ViT-B/16"], pcb.CLIP_CONFIGS["ViT-B/16"]
    jcb.CLIP_CONFIGS["ViT-B/16"] = jcb.ClipConfig(**TINY_CLIP)
    pcb.CLIP_CONFIGS["ViT-B/16"] = pcb.ClipConfig(**TINY_CLIP)
    yield
    jcb.CLIP_CONFIGS["ViT-B/16"], pcb.CLIP_CONFIGS["ViT-B/16"] = saved


def clip_ids(rng, b, n=77, vocab=49408):
    """Rows as the CLIP tokenizer lays them out: SOT, words, EOT (the
    largest id), zero padding."""
    ids = np.zeros((b, n), np.int32)
    for i, length in enumerate(rng.integers(4, 20, size=b)):
        ids[i, 0] = vocab - 2
        ids[i, 1:length - 1] = rng.integers(1, 40000, size=length - 2)
        ids[i, length - 1] = vocab - 1
    return ids


def _batch(seed):
    rng = np.random.default_rng(seed)
    batch = {"rgb": rng.standard_normal((B, 3, S, S)).astype(np.float32),
             "instruction": clip_ids(rng, B),
             "mask": (rng.random((B, 1, S, S)) > 0.4).astype(np.float32)}
    for h in HEADS:
        batch[f"{h}_heatmap"] = rng.random((B, S, S)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_setup(tiny_clip):
    model = jax_build_model(CFG)
    batch = _batch(0)
    variables = jax.jit(lambda k: model.init(
        k, {n: jnp.asarray(v) for n, v in batch.items()},
        deterministic=True))(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, params, batch


def _port(params, dtype=torch.float32):
    model = build_model(CFG, dtype=dtype, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           convert_bifold_inverse(params).items()}, strict=True)
    return model


def test_converters_match_jax(jax_setup):
    _, params, _ = jax_setup
    state = convert_bifold_inverse(params)
    want = jax_inverse(params)
    assert sorted(state) == sorted(want)
    assert "clip_encoder.visual.transformer.resblocks.1.attn.in_proj_weight" in state
    for k in want:
        np.testing.assert_array_equal(state[k], want[k], err_msg=k)
    port_state = {k: v.detach() for k, v in _port(params).state_dict().items()}
    got = convert_bifold(port_state)
    ref = jax_convert_bifold({k: v.numpy() for k, v in port_state.items()})
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(ref)]
    for (path, a), (_, b) in zip(flat(got), flat(ref)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_forward_matches_jax(jax_setup):
    model, params, batch = jax_setup
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = model.apply({"params": params}, jbatch, deterministic=True)
    port = _port(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = port(tbatch)
    for k in (f"{h}_{kind}" for h in HEADS for kind in ("logits", "heatmap")):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=F32_TOL,
                                   err_msg=k)
    ja = jax_decode_action(want, jbatch, is_bimanual=True, threshold=0.5)
    ta = decode_action(got, tbatch, is_bimanual=True, threshold=port.threshold)
    for k in HEADS:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=k)


# the processor node as the composed config gives it for rgb_clip at 64 px
PROC_CFG = {"text_encoder": "ViT-B/16", "sigma": 5, "model_image_size": S,
            "requires_graph": False, "spatial_augment": False, "strategy": "gmm",
            "mask_depth": True, "standardize_depth": False,
            "image_mean": [0.48145466, 0.4578275, 0.40821073],
            "image_std": [0.26862954, 0.26130258, 0.27577711]}


def observation(rng, size=96):
    return {"rgb": rng.integers(0, 255, (size, size, 3), dtype=np.uint8),
            "depth": rng.random((size, size)).astype(np.float32),
            "mask": (rng.random((size, size)) > 0.3).astype(np.float32)}


def test_serving_matches_jax(jax_setup):
    model, params, _ = jax_setup
    jserver = JaxServingModel(model, {"params": params},
                              JaxProcessor(PROC_CFG, partition="test"), threshold=0.5)
    tserver = ServingModel(_port(params), None, Processor(PROC_CFG), device="cpu")
    rng = np.random.default_rng(3)
    for text in ("fold the left sleeve to the center", "Plie la serviette, été"):
        obs = observation(rng)
        (ja, jr), (ta, tr) = (srv.predict(**obs, instruction=text, return_raw_output=True)
                              for srv in (jserver, tserver))
        for k in tr:
            np.testing.assert_allclose(tr[k], np.asarray(jr[k]), atol=F32_TOL, err_msg=k)
        for f in HEADS:
            np.testing.assert_array_equal(getattr(ta, f), np.asarray(getattr(ja, f)),
                                          err_msg=f)


def _jax_step(model, params, batch):
    mask = jax_trainable_mask(params, lora=False)
    tx, _ = jax_build_optimizer(dict(SGD), None, max_iters=10, trainable=mask,
                                gradient_clip=1.0)
    step = jax_parallel.make_train_step(model, jax_build_loss(dict(LOSS)), tx,
                                        donate=False, trainable=mask)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = (jparams, tx.init(jparams), {}, jax.random.key(0))
    (new_params, *_), metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (convert_bifold_inverse(jax.tree_util.tree_map(np.asarray, new_params)),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_train_step_matches_jax(jax_setup, backend, monkeypatch):
    if backend == "flash":
        monkeypatch.setenv("BIFOLD_ATTN_BACKEND", "flash")
        monkeypatch.setenv("BIFOLD_FLASH_INTERPRET", "1")
    model, params, batch = jax_setup
    old = convert_bifold_inverse(params)
    jax_new, jax_metrics = _jax_step(model, params, batch)
    port = _port(params)
    mask = trainable_mask(port, lora=False)
    opt = build_optimizer(dict(SGD), [p for p in port.parameters() if p.requires_grad],
                          max_iters=10, gradient_clip=1.0)
    launches = sum(fa.LAUNCHES.values())
    _, metrics = make_train_step(port, build_loss(dict(LOSS)), opt)(
        TrainState.create(opt), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sum(fa.LAUNCHES.values()) == launches          # plain versions only
    for k in ("loss", "grad_norm") + HEADS:
        np.testing.assert_allclose(float(metrics[k]), jax_metrics[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert not any(mask[n] for n in mask if n.startswith("clip_encoder."))
    state = port.state_dict()
    for k, trained in mask.items():
        if trained:
            np.testing.assert_allclose(state[k].numpy(), jax_new[k], atol=PARAM_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(state[k].numpy(), old[k], err_msg=k)


def _flags(tree):
    """JAX's quantize decisions of a params tree: the same tree of bool
    arrays (zero-copy broadcasts), which the inverse converters map to the
    port's names."""
    def leaf(node):
        if isinstance(node, dict) and JAX_QUANT_TAG in node:
            return np.broadcast_to(np.True_, node[JAX_QUANT_TAG].shape)
        if isinstance(node, dict):
            return {k: leaf(v) for k, v in node.items()}
        return np.broadcast_to(np.False_, node.shape)
    return leaf(tree)


def check_int8_decisions(port_weights, jax_tree, inverse, min_size):
    """The port quantizes exactly the tensors JAX does (from shapes alone
    when the weights are on the meta device)."""
    got = quantize_weights(port_weights, min_size=min_size)
    flags = {k: np.asarray(f) for k, f in inverse(_flags(jax_tree)).items()
             if k in port_weights}
    assert sorted(flags) == sorted(port_weights)
    want = sorted(k for k, f in flags.items() if f.all())
    assert all(f.all() or not f.any() for f in flags.values())
    assert sorted(k for k, v in got.items() if isinstance(v, dict)) == want
    return got, want


@pytest.mark.parametrize("min_size", [4096, 1024])
def test_int8_matches_jax(jax_setup, min_size):
    _, params, _ = jax_setup
    qtree = jax_quantize({"params": params}, min_size=min_size)["params"]
    got, want = check_int8_decisions(
        {k: torch.from_numpy(np.array(v)) for k, v in convert_bifold_inverse(params).items()},
        qtree, convert_bifold_inverse, min_size)
    assert "clip_encoder.visual.conv1.weight" in want
    assert "clip_encoder.text_projection" in want or min_size > 1024
    assert "clip_encoder.text_pos_embedding" not in want

    def split(node, which):
        if isinstance(node, dict) and JAX_QUANT_TAG in node:
            q = np.asarray(node[JAX_QUANT_TAG])
            return q if which == "q" else np.broadcast_to(np.asarray(node["scale"]), q.shape)
        if isinstance(node, dict):
            return {k: split(v, which) for k, v in node.items()}
        return np.zeros(np.shape(node), np.int8 if which == "q" else np.float32)

    qs, scales = (convert_bifold_inverse(split(qtree, w)) for w in ("q", "scale"))
    for k in want:
        np.testing.assert_array_equal(got[k][QUANT_TAG].numpy(), qs[k], err_msg=k)
        np.testing.assert_array_equal(np.broadcast_to(got[k]["scale"].numpy(),
                                                      qs[k].shape), scales[k], err_msg=k)


def test_int8_decisions_at_full_size():
    """At the shipped size (ViT-B/16 at 224 px, fusion 8 x 512) the tables
    stay float as JAX keeps them: the vision positions (197 x 768, past the
    2^16 minimum), rgb and text position embeddings, the token table."""
    full = dict(CFG, image_size=224, depth=8, heads=16)
    saved = jcb.CLIP_CONFIGS["ViT-B/16"], pcb.CLIP_CONFIGS["ViT-B/16"]
    jcb.CLIP_CONFIGS["ViT-B/16"] = jcb.ClipConfig()
    pcb.CLIP_CONFIGS["ViT-B/16"] = pcb.ClipConfig()
    try:
        jmodel = jax_build_model(full)
        sample = {"rgb": jax.ShapeDtypeStruct((1, 3, 224, 224), jnp.float32),
                  "instruction": jax.ShapeDtypeStruct((1, 77), jnp.int32)}
        shapes = jax.eval_shape(lambda s: jmodel.init(jax.random.key(0), s), sample)
        qtree = jax.eval_shape(lambda p: jax_quantize({"params": p})["params"],
                               shapes["params"])
        from bifold_tpu_torch.models.bifold_models import RGBOnly
        with torch.device("meta"):
            port = RGBOnly(224, True, depth=8, heads=16)
    finally:
        jcb.CLIP_CONFIGS["ViT-B/16"], pcb.CLIP_CONFIGS["ViT-B/16"] = saved
    _, want = check_int8_decisions({n: p.detach() for n, p in port.named_parameters()},
                                   qtree, convert_bifold_inverse, 2 ** 16)
    for table in ("clip_encoder.visual.positional_embedding", "rgb_pos_embedding",
                  "text_pos_embedding", "clip_encoder.token_embedding.weight"):
        assert table not in want, table
    assert "clip_encoder.text_projection" in want
    assert "clip_encoder.visual.conv1.weight" in want


def _overrides(run_dir):
    return ["train_dataset=synthetic", "test_dataset=null", "model=rgb_clip",
            "train_dataset.n_samples=16", "train_dataset.image_size=64",
            "train_dataset.is_bimanual=true", "model.image_size=64",
            "model.depth=1", "model.heads=1", "epochs=1", "eval_epochs=1",
            "batch_size=8", "test_batch_size=8", "simulator=null",
            f"run_dir={run_dir}", "log_every=1", "processor.spatial_augment=false",
            "precision.compute_dtype=float32", "gradient_clip=1.0"]


def _losses(run_dir):
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    return [r["train/loss"] for r in map(json.loads, lines) if "train/loss" in r]


def test_trainer_matches_jax(tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jt = JaxTrainer(JaxConfig(jax_compose(_overrides(jax_dir))), run_dir=jax_dir)
    init = convert_bifold_inverse(jax.tree_util.tree_map(np.asarray, jt.params))
    jt.prepare_train()
    jt.train()
    pt = Trainer(Config(compose(_overrides(port_dir) + ["use_cpu=true"])),
                 run_dir=port_dir)
    pt.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in init.items()},
                             strict=True)
    pt.prepare_train()
    pt.train()
    assert pt.global_step == jt.global_step == 2
    np.testing.assert_allclose(_losses(port_dir), _losses(jax_dir), rtol=LOSS_RTOL)
    final = convert_bifold_inverse(jax.tree_util.tree_map(np.asarray, jt.params))
    for n, p in pt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[n], rtol=0,
                                   atol=PARAM_ATOL if p.requires_grad else 0, err_msg=n)
    want = jt.get_action(next(iter(jt.test_dataloader)))
    got = pt.get_action(next(iter(pt.test_dataloader)))
    for (name, a), (_, b) in zip(got.fields(), want.fields()):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the JAX Trainer's checkpoint resumes in the port's
    resumed = Trainer(Config(compose(_overrides(tmp_path / "r") + ["use_cpu=true"])),
                      run_dir=tmp_path / "r")
    resumed.prepare_train()
    assert resumed.load_model(path=jt.ckpt_dir / "last.ckpt")
    assert resumed.global_step == 2
    for n, p in resumed.model.named_parameters():
        assert np.array_equal(p.detach().float().numpy(),
                              np.asarray(final[n], np.float32)), n


@pytest.mark.parametrize("extra, error", [
    ({"text_encoder": "RN50"}, ValueError),
    ({"pick_place_model": "bogus"}, ValueError),
    ({"bogus": 1}, TypeError)], ids=lambda v: str(v))
def test_unported_rgb_clip_options_raise(extra, error):
    with pytest.raises(error):
        build_model({**CFG, **extra}, device="cpu")


VARIANTS = {"transdecoder": {"pick_place_model": "pick_place_transdecoder"},
            "crossattention": {"fusion_model": "crossattention"}}
VARIANT_TOL = 1e-5


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax(variant):
    """rgb_clip with the transformer-decoder head or the cross-attention
    fusion: weights initialised in JAX convert and load strictly, and
    convert back to JAX's tree; the f32 forward within 1e-5 with equal
    actions; one f32 train step (SGD, clip 1.0) within 1e-5 of
    ``bifold_tpu.parallel.make_train_step``."""
    cfg = {**CFG, **VARIANTS[variant]}
    model = jax_build_model(cfg)
    batch = _batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: model.init(
        k, jbatch, deterministic=True))(jax.random.key(0))["params"])
    # names follow the JAX paths (JAX's own inverse converter names no
    # transformer-decoder head): a strict load, and the port's forward
    # converter gives JAX's tree back
    state = convert_bifold_inverse(params)
    port = build_model(cfg, device="cpu")
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                         strict=True)
    flat = jax.tree_util.tree_leaves_with_path
    back = convert_bifold({k: v.detach() for k, v in port.state_dict().items()})
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(params)]
    for (path, a), (_, b) in zip(flat(back), flat(params)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))

    out = jax.jit(lambda p: model.apply({"params": p}, jbatch, deterministic=True))(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = port(tbatch)
    for k in (f"{h}_{kind}" for h in HEADS for kind in ("logits", "heatmap")):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(out[k]), atol=VARIANT_TOL,
                                   err_msg=k)
    ja = jax_decode_action(out, jbatch, is_bimanual=True, threshold=0.5)
    ta = decode_action(got, tbatch, is_bimanual=True, threshold=port.threshold)
    for k in HEADS:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=k)

    jax_new, jax_metrics = _jax_step(model, params, batch)
    mask = trainable_mask(port, lora=False)
    opt = build_optimizer(dict(SGD), [p for p in port.parameters() if p.requires_grad],
                          max_iters=10, gradient_clip=1.0)
    _, metrics = make_train_step(port, build_loss(dict(LOSS)), opt)(
        TrainState.create(opt), tbatch)
    for k in ("loss", "grad_norm") + HEADS:
        np.testing.assert_allclose(float(metrics[k]), jax_metrics[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    new = port.state_dict()
    for k, trained in mask.items():
        np.testing.assert_allclose(new[k].numpy(), jax_new[k] if trained else state[k],
                                   atol=PARAM_ATOL if trained else 0, err_msg=k)
