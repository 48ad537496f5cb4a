"""The SigLIP families' head, fusion and FFN variants, whole model, against
the JAX package on the CPU.

The tiny SiglipSequential of ``test_torch_training.py`` (SigLIP "tiny"
towers, 64 px, dim 64, bimanual, 3 context frames, LoRA r8, dropout 0)
under each config-selected variant: ``pick_place_transdecoder`` (two
fusions, two float32 MAE decoders at their default width 512 and 16 heads
of 32), ``crossattention`` and ``moe_experts: 4`` (top-1, capacity 1.25,
aux weight 0.01). Weights are initialised in JAX (LoRA B nonzero) and
converted by the port. For each:

- the f32 forward: every output within 1e-4, the same decoded actions;
- one f32 train step (bce_gaussmap, SGD 0.5, clip 1.0): loss (the MoE
  load-balance term included), per-head terms, the load-balance value and
  gradient norm within 1e-5 relative, every trainable tensor after the
  step within 1e-5; the transformer decoder again on the flash path (the
  Pallas kernels in interpret mode against the plain versions);
- ``convert_bifold`` gives JAX's params tree exactly, and
  ``convert_bifold_inverse`` undoes it;
- a JAX checkpoint (Adam state, precast frozen leaves) served by the
  port's ``from_checkpoint`` as JAX's server serves it, and a checkpoint
  the port writes read by JAX's ``load_checkpoint`` into its model;
- int8: the port quantizes exactly the tensors JAX's ``quantize_weights``
  does, with equal payloads and scales, tiny at two minimum sizes and (from
  shapes) at the full 384 px size;
- an int8 export artifact and the HTTP daemon serve each variant bitwise
  as the live server does.
"""

import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from bifold_tpu import parallel as jax_parallel
from bifold_tpu.data.spm import fixture_model_bytes
from bifold_tpu.losses import build_loss as jax_build_loss
from bifold_tpu.models import build_model as jax_build_model
from bifold_tpu.models import decode_action as jax_decode_action
from bifold_tpu.models import precast_frozen as jax_precast_frozen
from bifold_tpu.models import trainable_mask as jax_trainable_mask
from bifold_tpu.optim import build_optimizer as jax_build_optimizer
from bifold_tpu.serving import _QUANT_TAG as JAX_QUANT_TAG
from bifold_tpu.serving import ServingModel as JaxServingModel
from bifold_tpu.serving import quantize_weights as jax_quantize
from bifold_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from bifold_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.models import build_model, decode_action, trainable_mask
from bifold_tpu_torch.models.bifold_models import SiglipSequential
from bifold_tpu_torch.models.convert import convert_bifold, convert_bifold_inverse
from bifold_tpu_torch.ops import flash_attention as fa
from bifold_tpu_torch.optim import build_optimizer
from bifold_tpu_torch.parallel import TrainState, make_train_step
from bifold_tpu_torch.data.processor import Processor
from bifold_tpu_torch.serve import RemotePolicy, make_httpd
from bifold_tpu_torch.serving import QUANT_TAG, ServingModel
from bifold_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_deployment import _equal, _post, restore_spm_env
from test_torch_rgb_clip import check_int8_decisions
from test_torch_serving import PROC_CFG, _observation
from test_torch_training import CFG as BASE, HEADS, LOSS, SGD, _batch

F32_TOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
VARIANTS = {
    "transdecoder": {"pick_place_model": "pick_place_transdecoder"},
    "crossattention": {"fusion_model": "crossattention"},
    "moe": {"moe_experts": 4, "moe_top_k": 1, "moe_capacity_factor": 1.25,
            "moe_aux_weight": 0.01},
}


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(variant):
    return {**BASE, **VARIANTS[variant]}


_SETUPS = {}


def _setup(variant):
    """(JAX model, f32 params with nonzero LoRA B, a batch), once per
    variant."""
    if variant not in _SETUPS:
        model = jax_build_model(_cfg(variant))
        batch = _batch(0)
        variables = jax.jit(lambda k: model.init(
            k, {n: jnp.asarray(v) for n, v in batch.items()},
            deterministic=True))(jax.random.key(0))
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        rng = np.random.default_rng(1)

        def bump(tree):
            return {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32)
                    if k == "lora_b" else (bump(v) if isinstance(v, dict) else v)
                    for k, v in tree.items()}

        _SETUPS[variant] = (model, bump(params), batch)
    return _SETUPS[variant]


def _port(variant, params):
    model = build_model(_cfg(variant), device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           convert_bifold_inverse(params).items()}, strict=True)
    return model


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant):
    model, params, batch = _setup(variant)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = model.apply({"params": params}, jbatch, deterministic=True)
    port = _port(variant, params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = port(tbatch)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v is not None:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=F32_TOL,
                                       err_msg=k)
    ja = jax_decode_action(want, jbatch, is_bimanual=True, threshold=0.01)
    ta = decode_action(got, tbatch, is_bimanual=True, threshold=port.threshold)
    for k in HEADS:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=k)


def _jax_step(model, params, batch, aux_weight):
    mask = jax_trainable_mask(params, lora=True)
    tx, _ = jax_build_optimizer(dict(SGD), None, max_iters=10, trainable=mask,
                                gradient_clip=1.0)
    step = jax_parallel.make_train_step(model, jax_build_loss(dict(LOSS)), tx,
                                        donate=False, trainable=mask,
                                        moe_aux_weight=aux_weight)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = (jparams, tx.init(jparams), {}, jax.random.key(0))
    (new_params, *_), metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (convert_bifold_inverse(jax.tree_util.tree_map(np.asarray, new_params)),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("variant, backend", [
    ("transdecoder", "xla"), ("transdecoder", "flash"), ("crossattention", "xla"),
    ("moe", "xla")])
def test_train_step_matches_jax(variant, backend, monkeypatch):
    if backend == "flash":
        monkeypatch.setenv("BIFOLD_ATTN_BACKEND", "flash")
        monkeypatch.setenv("BIFOLD_FLASH_INTERPRET", "1")
    model, params, batch = _setup(variant)
    aux_weight = VARIANTS[variant].get("moe_aux_weight", 0.0) if variant == "moe" else 0.0
    old = convert_bifold_inverse(params)
    jax_new, jax_metrics = _jax_step(model, params, batch, aux_weight)
    port = _port(variant, params)
    mask = trainable_mask(port, lora=True)
    opt = build_optimizer(dict(SGD), [p for p in port.parameters() if p.requires_grad],
                          max_iters=10, gradient_clip=1.0)
    launches = sum(fa.LAUNCHES.values())
    _, metrics = make_train_step(port, build_loss(dict(LOSS)), opt,
                                 moe_aux_weight=aux_weight)(
        TrainState.create(opt), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sum(fa.LAUNCHES.values()) == launches          # plain versions only
    keys = ("loss", "grad_norm") + HEADS
    if variant == "moe":
        keys += ("moe_load_balance",)
        assert jax_metrics["moe_load_balance"] > 0.5
    assert sorted(metrics) == sorted(jax_metrics)
    for k in keys:
        np.testing.assert_allclose(float(metrics[k]), jax_metrics[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    state = port.state_dict()
    assert any(mask[n] for n in mask if n.startswith("pick_place."))
    for k, trained in mask.items():
        if trained:
            np.testing.assert_allclose(state[k].numpy(), jax_new[k], atol=PARAM_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(state[k].numpy(), old[k], err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_converters_roundtrip(variant):
    _, params, _ = _setup(variant)
    state = convert_bifold_inverse(params)
    port_state = {k: v.detach() for k, v in _port(variant, params).state_dict().items()}
    assert sorted(port_state) == sorted(state)
    tree = convert_bifold({k: v.numpy() for k, v in port_state.items()})
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(tree)] == [p for p, _ in flat(params)]
    for (path, a), (_, b) in zip(flat(tree), flat(params)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    back = convert_bifold_inverse(tree)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_checkpoints_both_ways(variant, tmp_path, monkeypatch):
    restore_spm_env(monkeypatch)
    model, params, batch = _setup(variant)
    cfg = {"model": _cfg(variant), "processor": dict(PROC_CFG)}
    # a JAX trainer checkpoint, served by the port as by JAX
    mask = jax_trainable_mask(params, lora=True)
    stored = jax_precast_frozen(params, mask, jnp.bfloat16, min_size=4096)
    opt_state = optax.adam(1e-4).init(jax.tree_util.tree_map(jnp.asarray, params))
    path = jax_save_checkpoint(tmp_path / "jax" / "last.ckpt", params=stored,
                               opt_state=opt_state, jax_key=jax.random.key(0),
                               metadata={"model": cfg["model"]})
    (path.parent / "spiece.model").write_bytes(fixture_model_bytes())
    (tmp_path / "jax" / "config.yaml").write_text(yaml.safe_dump(cfg))
    port_server = ServingModel.from_checkpoint(path, cfg, device="cpu")
    jax_server = JaxServingModel.from_checkpoint(str(path), cfg)
    obs = dict(_observation(np.random.default_rng(2), 3), instruction="fold it")
    (ja, jr), (ta, tr) = (s.predict(**obs, return_raw_output=True)
                          for s in (jax_server, port_server))
    assert sorted(tr) == sorted(k for k, v in jr.items() if v is not None)
    for k in tr:
        np.testing.assert_allclose(tr[k], np.asarray(jr[k]), atol=F32_TOL, err_msg=k)
    for f in HEADS:
        np.testing.assert_array_equal(getattr(ta, f), np.asarray(getattr(ja, f)))
    # a checkpoint the port writes, read by JAX into its model
    port = _port(variant, params)
    out = save_checkpoint(tmp_path / "port.ckpt",
                          params=convert_bifold(port.state_dict()),
                          metadata={"model": cfg["model"]})
    loaded = jax_load_checkpoint(out)["params"]
    want = model.apply({"params": loaded}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in HEADS:
        np.testing.assert_allclose(got[f"{k}_heatmap"].numpy(),
                                   np.asarray(want[f"{k}_heatmap"]), atol=F32_TOL, err_msg=k)


def _split(node, which):
    if isinstance(node, dict) and JAX_QUANT_TAG in node:
        q = np.asarray(node[JAX_QUANT_TAG])
        return q if which == "q" else np.broadcast_to(np.asarray(node["scale"]), q.shape)
    if isinstance(node, dict):
        return {k: _split(v, which) for k, v in node.items()}
    return np.zeros(np.shape(node), np.int8 if which == "q" else np.float32)


# minimum sizes at which every stacked one-dim leaf stays float (the port
# refuses to quantize one across layers): the decoders' fc1 biases stack to
# 2 x 2048 elements whatever the model's width
@pytest.mark.parametrize("variant, min_size", [
    ("transdecoder", 8192), ("transdecoder", 2 ** 16), ("crossattention", 4096),
    ("crossattention", 1024), ("moe", 4096), ("moe", 1024)])
def test_int8_matches_jax(variant, min_size):
    _, params, _ = _setup(variant)
    qtree = jax_quantize({"params": params}, min_size=min_size)["params"]
    got, want = check_int8_decisions(
        {k: torch.from_numpy(np.array(v)) for k, v in convert_bifold_inverse(params).items()},
        qtree, convert_bifold_inverse, min_size)
    new = [k for k in want if k.startswith(("pick_place.pick_", "pick_place.place_"))
           or ".cross_attention." in k or k.endswith((".w1", ".w2", ".router"))]
    assert new, "no variant tensor was quantized"
    qs, scales = (convert_bifold_inverse(_split(qtree, w)) for w in ("q", "scale"))
    for k in want:
        np.testing.assert_array_equal(got[k][QUANT_TAG].numpy(), qs[k], err_msg=k)
        np.testing.assert_array_equal(np.broadcast_to(got[k]["scale"].numpy(),
                                                      qs[k].shape), scales[k], err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_int8_decisions_at_full_size(variant):
    """At 384 px with the SigLIP-base towers, depth-8 fusion(s) of 16 heads:
    the decisions from shapes alone, JAX's against the port's."""
    full = {**BASE, "image_size": 384, "automodel_name": "google/siglip-base-patch16-384",
            "dim": 768, "depth": 8, "heads": 16, **VARIANTS[variant]}
    if variant == "moe":
        full["moe_experts"] = 8
    jmodel = jax_build_model(full)
    sample = {"rgb": jax.ShapeDtypeStruct((1, 3, 384, 384), jnp.float32),
              "instruction": jax.ShapeDtypeStruct((1, 64), jnp.int32),
              "rgb_context": jax.ShapeDtypeStruct((1, 3, 3, 384, 384), jnp.float32),
              "context_attention_mask": jax.ShapeDtypeStruct((1, 3), jnp.int32)}
    shapes = jax.eval_shape(lambda s: jmodel.init(jax.random.key(0), s), sample)
    qtree = jax.eval_shape(lambda p: jax_quantize({"params": p})["params"],
                           shapes["params"])
    kw = {k: v for k, v in full.items() if k != "name"}
    with torch.device("meta"):
        port = SiglipSequential(**kw)
    _, want = check_int8_decisions({n: p.detach() for n, p in port.named_parameters()},
                                   qtree, convert_bifold_inverse, 2 ** 16)
    for table in ("context_pos_embedding", "pick_place.fusion.token_type_embeddings.weight",
                  "pick_place.pick_fusion.token_type_embeddings.weight"):
        assert table not in want, table
    if variant == "moe":
        assert "pick_place.fusion.transformer_encoder.layers.0.1.fn.w1" in want
        assert "pick_place.fusion.transformer_encoder.layers.0.1.fn.b1" in want
    if variant == "crossattention":
        assert "pick_place.fusion.cross_attention.out.kernel" in want
    if variant == "transdecoder":
        assert "pick_place.pick_decoder.blocks.layers.1.mlp.fc1.weight" in want


@pytest.mark.parametrize("variant", VARIANTS)
def test_artifact_and_daemon_serve_variant(variant, tmp_path):
    _, params, _ = _setup(variant)
    proc = Processor(PROC_CFG, max_context_length=3, autoprocessor_name="tiny",
                     spm_asset=fixture_model_bytes())
    live = ServingModel(_port(variant, params), None, proc, device="cpu",
                        quantize="int8",
                        quantize_min_size=8192 if variant == "transdecoder" else 4096)
    rng = np.random.default_rng(5)
    obs = dict(_observation(rng, 3), instruction="fold the towel")
    want = live.predict(**obs, return_raw_output=True)
    art = ServingModel.load_exported(live.export(tmp_path / "a.pt", **obs), device="cpu")
    _equal(art.predict(**obs, return_raw_output=True), want)
    httpd = make_httpd(live)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, data = _post(httpd.server_address[1], "/predict?raw=1",
                             RemotePolicy._pack([obs]))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 200, data
    out = dict(np.load(io.BytesIO(data)))
    action, raw = want
    for k, v in raw.items():
        np.testing.assert_array_equal(out[f"raw_{k}"], v, err_msg=k)
    for f in HEADS:
        np.testing.assert_array_equal(out[f], getattr(action, f), err_msg=f)
