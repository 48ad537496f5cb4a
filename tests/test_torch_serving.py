"""The port's serving slice against the JAX package's, end to end on the CPU.

A tiny SiglipSequential (SigLIP "tiny" towers, 64 px, dim 64, bimanual,
3 context frames, LoRA on q/v) is initialised in JAX, converted with the
port's ``convert_bifold_inverse`` and loaded into the port with
``strict=True``. Both ``ServingModel``s then serve the same uint8 frames,
masks, depths and instructions: float32 heatmaps and logits agree within
1e-4 and the decoded actions are equal, against the JAX XLA path and
against the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.data.processor import Processor as JaxProcessor
from bifold_tpu.data import tokenizers as jax_tokenizers
from bifold_tpu.data.spm import fixture_model_bytes
from bifold_tpu.models import build_model as jax_build_model
from bifold_tpu.models.convert import convert_bifold_inverse as jax_inverse
from bifold_tpu.serving import ServingModel as JaxServingModel
from bifold_tpu.serving import _stack_raws
from bifold_tpu_torch.data import tokenizers as port_tokenizers
from bifold_tpu_torch.data.processor import Processor, _core
from bifold_tpu_torch.models import build_model, trainable_mask
from bifold_tpu_torch.models.convert import convert_bifold_inverse
from bifold_tpu_torch.ops import flash_attention as fa
from bifold_tpu_torch.serving import ServingModel, ServingPolicy

F32_TOL = 1e-4
# bf16 keeps 8 significant bits; XLA and torch round the activations at
# different places (fused elementwise chains, matmul kernels), so a few ulps
# of difference per layer reach the float32 heads after the 2 + 2 + 2 layers
# here: measured <= 0.024 on logits and <= 0.006 on heatmaps.
BF16_LOGIT_TOL = 0.06
BF16_HEATMAP_TOL = 0.015

CFG = {"name": "siglip_sequential", "image_size": 64, "is_bimanual": True,
       "patch_size": 16, "automodel_name": "tiny", "dim": 64, "lora": True,
       "r": 8, "lora_alpha": 32, "lora_dropout": 0.01, "depth": 2, "heads": 4,
       "context_length": 3, "threshold": 0.01}
PROC_CFG = {"model_image_size": 64, "text_encoder": None, "sigma": 5,
            "requires_graph": False, "spatial_augment": False,
            "strategy": "gmm", "mask_depth": True, "standardize_depth": False}
FIELDS = ("left_pick", "right_pick", "left_place", "right_place")
INSTRUCTIONS = ("fold the left sleeve to the right",
                "Fold the towel in half, bottom to top!", "unfold it")


def _jax_params(dtype):
    model = jax_build_model(CFG, dtype=dtype)
    init = {"rgb": np.zeros((1, 3, 64, 64), np.float32),
            "instruction": np.zeros((1, 64), np.int32),
            "rgb_context": np.zeros((1, 3, 3, 64, 64), np.float32),
            "context_attention_mask": np.ones((1, 3), np.int32)}
    variables = jax.jit(lambda k: model.init(
        k, {n: jnp.asarray(v) for n, v in init.items()},
        deterministic=True))(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(1)

    def bump(tree):  # nonzero LoRA B so the adapters contribute
        return {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32)
                if k == "lora_b" else (bump(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}

    return model, bump(params)


@pytest.fixture(scope="module")
def f32_pair():
    model, params = _jax_params(jnp.float32)
    return model, params, convert_bifold_inverse(params)


def _servers(jax_model, params, state, dtype, **kw):
    spm = fixture_model_bytes()
    jproc = JaxProcessor(PROC_CFG, partition="test", max_context_length=3,
                         autoprocessor_name="tiny", spm_asset=spm)
    tproc = Processor(PROC_CFG, max_context_length=3,
                      autoprocessor_name="tiny", spm_asset=spm)
    jserver = JaxServingModel(jax_model, {"params": params}, jproc,
                              threshold=0.01, **kw)
    tserver = ServingModel(build_model(CFG, dtype=dtype, device="cpu"), state,
                           tproc, device="cpu", **kw)
    return jserver, tserver


def _observation(rng, n_ctx, size=80):
    def frame():
        return dict(rgb=rng.integers(0, 255, (size, size, 3), dtype=np.uint8),
                    depth=rng.random((size, size)).astype(np.float32),
                    mask=(rng.random((size, size)) > 0.3).astype(np.float32))
    obs = frame()
    obs["mask"][:8] = 0.5                 # soft values ride the k/255 wire
    obs["context"] = [frame() for _ in range(n_ctx)]
    return obs


def _compare(jax_out, port_out, logit_tol, heatmap_tol):
    (ja, jr), (ta, tr) = jax_out, port_out
    assert sorted(tr) == sorted(k for k in jr if jr[k] is not None)
    for k in tr:
        tol = logit_tol if k.endswith("_logits") else heatmap_tol
        np.testing.assert_allclose(tr[k], np.asarray(jr[k]), atol=tol, err_msg=k)
    return [(np.asarray(getattr(ja, f)), getattr(ta, f)) for f in FIELDS]


def test_convert_matches_jax_and_loads_strict(f32_pair):
    _, params, state = f32_pair
    ref = jax_inverse(params)
    assert sorted(state) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(state[k], ref[k], err_msg=k)
    model = build_model(CFG, device="cpu")
    result = model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
        strict=True)
    assert not result.missing_keys and not result.unexpected_keys


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_predict_matches_jax_f32(f32_pair, backend, monkeypatch):
    """``flash``: the JAX side runs its Pallas kernel in interpret mode and
    the port its flash wrapper (the kernel's plain version on the CPU)."""
    if backend == "flash":
        monkeypatch.setenv("BIFOLD_ATTN_BACKEND", "flash")
        monkeypatch.setenv("BIFOLD_FLASH_INTERPRET", "1")
    jax_model, params, state = f32_pair
    jserver, tserver = _servers(jax_model, params, state, torch.float32)
    rng = np.random.default_rng(2)
    for n_ctx, text in zip((0, 2, 3), INSTRUCTIONS):
        obs = _observation(rng, n_ctx)
        pairs = _compare(jserver.predict(**obs, instruction=text, return_raw_output=True),
                         tserver.predict(**obs, instruction=text, return_raw_output=True),
                         F32_TOL, F32_TOL)
        for ja, ta in pairs:
            np.testing.assert_array_equal(ta, ja)
    assert sum(fa.LAUNCHES.values()) == 0


def test_predict_batch_matches_jax_f32(f32_pair):
    """A pool of 3 padded to 4, depth on the float16 wire."""
    jax_model, params, state = f32_pair
    jserver, tserver = _servers(jax_model, params, state, torch.float32,
                                depth_wire_dtype="float16")
    rng = np.random.default_rng(3)
    obs = [dict(_observation(rng, n), instruction=t)
           for n, t in zip((1, 3, 0), INSTRUCTIONS)]
    pairs = _compare(jserver.predict_batch(obs, pad_to=4, return_raw_output=True),
                     tserver.predict_batch(obs, pad_to=4, return_raw_output=True),
                     F32_TOL, F32_TOL)
    for ja, ta in pairs:
        assert ta.shape == (3, 2)
        np.testing.assert_array_equal(ta, ja)
    action, _ = ServingPolicy(tserver)(obs, pad_to=4)
    np.testing.assert_array_equal(action.left_pick, pairs[0][1])


def test_predict_matches_jax_bf16():
    """The shipped compute dtype, with the one-time bf16 precast on both
    sides (tolerances stated at the top of the file)."""
    jax_model, params = _jax_params(jnp.bfloat16)
    jserver, tserver = _servers(jax_model, params, convert_bifold_inverse(params),
                                torch.bfloat16)
    big = [p for p in tserver.model.parameters() if p.numel() >= 2 ** 16]
    assert big and all(p.dtype == torch.bfloat16 for p in big)
    assert all(p.dtype == torch.float32 for p in tserver.model.parameters()
               if p.numel() < 2 ** 16)
    obs = _observation(np.random.default_rng(4), 2)
    _compare(jserver.predict(**obs, instruction=INSTRUCTIONS[0], return_raw_output=True),
             tserver.predict(**obs, instruction=INSTRUCTIONS[0], return_raw_output=True),
             BF16_LOGIT_TOL, BF16_HEATMAP_TOL)


@pytest.mark.parametrize("asset", ["fixture", "ensure_fixture", "hash"])
def test_make_raw_token_ids_match_jax(asset, monkeypatch):
    """The SigLIP sentencepiece path (the generated fixture model, passed
    as bytes or installed by ``ensure_spm_fixture``) and, without any asset,
    the hashing fallback give the JAX package's ids."""
    # set, then delete: teardown then removes what ensure_spm_fixture sets
    monkeypatch.setenv("BIFOLD_SIGLIP_SPM", "")
    monkeypatch.delenv("BIFOLD_SIGLIP_SPM")
    spm = fixture_model_bytes() if asset == "fixture" else None
    if asset == "ensure_fixture":
        assert port_tokenizers.ensure_spm_fixture() is not None
        jax_tokenizers.ensure_spm_fixture()      # the same path, same bytes
    jproc = JaxProcessor(PROC_CFG, partition="test", max_context_length=3,
                         autoprocessor_name="tiny", spm_asset=spm)
    tproc = Processor(PROC_CFG, max_context_length=3, autoprocessor_name="tiny",
                      spm_asset=spm)
    assert type(tproc.tokenize).__name__ == type(jproc.tokenize).__name__
    for text in INSTRUCTIONS + ("", "grasp   the CORNER & pull; then smooth"):
        np.testing.assert_array_equal(tproc.make_raw(instruction=text)["instruction"],
                                      jproc.make_raw(instruction=text)["instruction"])


def test_processor_core_matches_jax():
    """The test-partition core on its own: composite, bicubic resize,
    SigLIP normalize, masked depth, rounded mask, context padding and mask,
    label scaling (f32 resize sums in another order: 1e-4; raw_rgb within
    one uint8 step of rounding)."""
    rng = np.random.default_rng(5)
    spm = fixture_model_bytes()
    jproc = JaxProcessor(PROC_CFG, partition="test", max_context_length=3,
                         autoprocessor_name="tiny", spm_asset=spm)
    tproc = Processor(PROC_CFG, max_context_length=3, autoprocessor_name="tiny",
                      spm_asset=spm)
    raws = [jproc.make_raw(**_observation(rng, n, size=72), instruction="fold",
                           left_pick=np.array([10.0, 20.0]), right_place=None)
            for n in (1, 3)]
    batched = _stack_raws(raws)
    batched["label_keys"] = raws[0]["label_keys"]
    ref = jproc.process_batch(batched)
    x = {k: torch.from_numpy(np.array(v)) for k, v in batched.items()
         if isinstance(v, np.ndarray)}
    spec = tproc._spec(batched)
    out = _core(spec, x["rgb"], x["depth"], x["mask"], x["ctx_rgb"],
                x["ctx_depth"], x["ctx_mask"], x["ctx_count"],
                {k: x[k] for k in spec.label_keys})
    assert sorted(out) == sorted(k for k in ref if k not in
                                 ("instruction", "raw_instruction"))
    for k in out:
        tol = 1 if k == "raw_rgb" else 1e-4
        np.testing.assert_allclose(out[k].numpy().astype(np.float32),
                                   np.asarray(ref[k]).astype(np.float32),
                                   atol=tol, err_msg=k)


def test_siglip_unimanual_matches_jax():
    """The context-free family, unimanual (pick/place heads, mask snap)."""
    cfg = {k: v for k, v in CFG.items() if k != "context_length"}
    cfg.update(name="siglip", is_bimanual=False)
    model = jax_build_model(cfg)
    init = {"rgb": np.zeros((1, 3, 64, 64), np.float32),
            "instruction": np.zeros((1, 64), np.int32)}
    variables = jax.jit(lambda k: model.init(
        k, {n: jnp.asarray(v) for n, v in init.items()},
        deterministic=True))(jax.random.key(1))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    spm = fixture_model_bytes()
    jserver = JaxServingModel(model, {"params": params}, JaxProcessor(
        PROC_CFG, partition="test", autoprocessor_name="tiny", spm_asset=spm),
        threshold=0.01)
    tserver = ServingModel(build_model(cfg, device="cpu"),
                           convert_bifold_inverse(params),
                           Processor(PROC_CFG, autoprocessor_name="tiny",
                                     spm_asset=spm), device="cpu")
    obs = _observation(np.random.default_rng(6), 0)
    del obs["context"]
    (ja, jr), (ta, tr) = (srv.predict(**obs, instruction=INSTRUCTIONS[1],
                                      return_raw_output=True)
                          for srv in (jserver, tserver))
    for k in tr:
        np.testing.assert_allclose(tr[k], np.asarray(jr[k]), atol=F32_TOL, err_msg=k)
    np.testing.assert_array_equal(ta.pick, np.asarray(ja.pick))
    np.testing.assert_array_equal(ta.place, np.asarray(ja.place))


def test_server_leaves_the_callers_model_untouched():
    """ServingModel precasts and switches to eval on its own copy: a bf16
    model in training keeps its float32 trainable masters, its frozen
    weights and its train mode, and serves what a server built from an
    identical fresh model serves."""
    jax_model, params = _jax_params(jnp.bfloat16)
    state = convert_bifold_inverse(params)
    model = build_model(CFG, dtype=torch.bfloat16, device="cpu")
    mask = trainable_mask(model, lora=True)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    proc = Processor(PROC_CFG, max_context_length=3, autoprocessor_name="tiny",
                     spm_asset=fixture_model_bytes())
    server = ServingModel(model, None, proc, device="cpu")
    assert model.training and not server.model.training
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
        assert torch.equal(p.detach(), before[n]), n
    assert any(p.dtype == torch.bfloat16 for p in server.model.parameters())
    assert any(mask.values())
    fresh = ServingModel(build_model(CFG, dtype=torch.bfloat16, device="cpu"),
                         state, proc, device="cpu")
    obs = _observation(np.random.default_rng(7), 2)
    (a, ra), (b, rb) = (srv.predict(**obs, instruction=INSTRUCTIONS[0],
                                    return_raw_output=True)
                        for srv in (server, fresh))
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="not available"):
        build_model(CFG)
    proc = Processor(PROC_CFG, max_context_length=3, autoprocessor_name="tiny",
                     spm_asset=fixture_model_bytes())
    with pytest.raises(RuntimeError, match="not available"):
        ServingModel(build_model(CFG, device="cpu"), None, proc)
