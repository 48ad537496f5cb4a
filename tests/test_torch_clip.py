"""The port's CLIP pieces against the JAX package's, on the CPU.

- The CLIP towers (a tiny ViT configuration, as tests/test_models.py uses)
  initialised in JAX, converted by the port's ``convert_bifold_inverse`` and
  loaded with ``strict=True``: image tokens, text tokens and the pooled,
  projected text features in float32 within 1e-5 (both sides sum in f32 in
  other orders).
- QuickGELU: forward and gradient against ``jax.vjp`` of the JAX custom VJP
  within 1e-5, and autograd keeps only its input, as that VJP does.
- The CLIP BPE ids equal JAX's on ASCII, non-ASCII and over-long
  instructions, tokenized by the port in a process where ``regex`` cannot be
  imported (JAX's tokenizer here uses ``regex``'s Unicode classes).
- The flash kernels' plain forward, forward with lse and backward at head
  dim 32 (``rgb_clip``'s fusion: 16 heads of 512) against the Pallas
  kernels in interpret mode: 1e-4 on rows with an unmasked key, 2e-3 on
  all-masked rows, lse 1e-4 of max(1, |lse|), as
  tests/test_torch_flash_attention.py holds d48 and d64.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.data.tokenizers import ClipBPETokenizer as JaxBPE
from bifold_tpu.models.backbones import clip_backbone as jcb
from bifold_tpu.ops.flash_attention import _fwd_impl as jax_fwd_with_lse
from bifold_tpu.ops.flash_attention import flash_attention as jax_flash
from bifold_tpu_torch.data import tokenizers as port_tokenizers
from bifold_tpu_torch.models import init_weights
from bifold_tpu_torch.models import layers as tl
from bifold_tpu_torch.models.backbones import ClipBackbone, ClipConfig
from bifold_tpu_torch.models.bifold_models import RGBOnly
from bifold_tpu_torch.models.convert import convert_bifold_inverse
from bifold_tpu_torch.ops import flash_attention as fa

TOWER_TOL = 1e-5
GRAD_TOL = 1e-5
NORMAL_TOL = 1e-4
DEGENERATE_TOL = 2e-3

TINY = dict(image_size=64, patch_size=16, vision_width=64, vision_layers=2,
            vision_heads=4, text_width=32, text_layers=2, text_heads=4,
            context_length=16, vocab_size=1000, embed_dim=32)


def _ids(rng, b, n, vocab):
    """Token rows as a tokenizer lays them out: SOT, words, EOT (the largest
    id), zero padding."""
    ids = np.zeros((b, n), np.int32)
    for i, length in enumerate(rng.integers(3, n, size=b)):
        ids[i, 0] = vocab - 2
        ids[i, 1:length - 1] = rng.integers(1, vocab - 2, size=length - 2)
        ids[i, length - 1] = vocab - 1
    return ids


@pytest.fixture(scope="module")
def towers():
    cfg = jcb.ClipConfig(**TINY)
    model = jcb.ClipBackbone(cfg=cfg)
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
    ids = _ids(rng, 2, 16, 1000)
    variables = model.init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(pixels))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    state = {k.removeprefix("clip_encoder."): v for k, v in
             convert_bifold_inverse({"clip_encoder": params}).items()}
    port = ClipBackbone(ClipConfig(**TINY))
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                         strict=True)
    return model, variables, port, pixels, ids


def test_clip_towers_match_jax(towers):
    model, variables, port, pixels, ids = towers
    want = {
        "image": model.apply(variables, jnp.asarray(pixels),
                             method=model.encode_image_with_embeddings),
        "text": model.apply(variables, jnp.asarray(ids),
                            method=model.encode_text_with_embeddings),
        "pooled": model.apply(variables, jnp.asarray(ids), method=model.encode_text),
    }
    with torch.no_grad():
        got = {"image": port.encode_image_with_embeddings(torch.from_numpy(pixels)),
               "text": port.encode_text_with_embeddings(torch.from_numpy(ids)),
               "pooled": port.encode_text(torch.from_numpy(ids))}
    assert got["image"].shape == (2, 17, 64) and got["pooled"].shape == (2, 32)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=TOWER_TOL,
                                   err_msg=k)


def test_clip_init_follows_jax_distributions():
    """The seeded init draws CLIP's tables with JAX's scales: class and
    vision positions N(0, width^-0.5), text positions N(0, 0.01), tokens
    N(0, 0.02), text_projection N(0, width^-0.5)."""
    cfg = ClipConfig(**{**TINY, "vision_width": 256, "text_width": 128,
                        "context_length": 77})
    port = ClipBackbone(cfg)
    init_weights(port, torch.Generator().manual_seed(0))
    stds = {"visual.positional_embedding": 256 ** -0.5,
            "positional_embedding": 0.01,
            "token_embedding.weight": 0.02,
            "text_projection": 128 ** -0.5}
    params = dict(port.named_parameters())
    for name, std in stds.items():
        assert abs(float(params[name].detach().std()) / std - 1) < 0.1, name
    assert float(params["visual.transformer.resblocks.0.attn.in_proj_bias"].abs().max()) == 0


def test_quick_gelu_matches_jax_and_saves_only_x():
    rng = np.random.default_rng(3)
    x = (2.0 * rng.normal(size=(3, 5, 64))).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    out, vjp = jax.vjp(jcb.quick_gelu, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        got = tl.quick_gelu(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=GRAD_TOL)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    assert len(saved) == 1 and saved[0] is xt
    bf = torch.from_numpy(x).bfloat16()
    assert tl.quick_gelu(bf).dtype == torch.bfloat16


TEXTS = [
    "fold the left sleeve to the center",
    "Fold the towel in half, bottom to top!",
    "it's folded; we'll unfold what they'd folded &amp; more",
    "Plie la manche gauche vers le centre: été, naïve, über, straße",
    "折りたたむ 袖を 中央へ ٣٤ ½ Ⅻ x² ǅemal İstanbul",
    "emoji 🙂👕 and\ttabs\nnewlines",
    " ".join(f"fold{i}" for i in range(60)),          # past 77 tokens
    "",
]

_PORT_IDS = """
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "regex" or name.startswith("regex."):
            raise ImportError("regex is blocked")
sys.meta_path.insert(0, Block())
from bifold_tpu_torch.data.tokenizers import build_tokenizer
tok = build_tokenizer(None, text_encoder="ViT-B/16")
print(json.dumps([tok(t).tolist() for t in json.loads(sys.argv[1])]))
assert "regex" not in sys.modules
"""


def test_clip_bpe_ids_equal_jax_without_regex():
    pytest.importorskip("regex")        # JAX's tokenizer then uses \\p{L}/\\p{N}
    path = port_tokenizers.clip_bpe_path()
    assert path is not None and "bifold_tpu_torch" in str(path)
    ref = JaxBPE("bifold_tpu/data/assets/bpe_simple_vocab_16e6.txt.gz")
    proc = subprocess.run([sys.executable, "-c", _PORT_IDS, json.dumps(TEXTS)],
                          capture_output=True, text=True, check=True)
    got = json.loads(proc.stdout)
    for text, ids in zip(TEXTS, got):
        want = ref(text)
        np.testing.assert_array_equal(np.asarray(ids, np.int32), want, err_msg=text)
    assert got[6][76] == ref.eot and got[7][:3] == [ref.sot, ref.eot, 0]
    # the ASCII classes would split the non-ASCII words differently
    assert port_tokenizers._clip_words("été über") == ["été", "über"]


def test_clip_hash_fallback_layout(monkeypatch):
    monkeypatch.setenv("BIFOLD_CLIP_BPE", "/nonexistent")
    monkeypatch.setattr(port_tokenizers, "clip_bpe_path", lambda: None)
    with pytest.warns(UserWarning, match="hashing"):
        tok = port_tokenizers.build_tokenizer(None, text_encoder="RN50")
    ids = tok("fold it, now")
    assert ids.shape == (77,) and ids[0] == 49406 and ids[5] == 49407
    assert (ids[6:] == 0).all() and (ids[1:5] < 49406).all()
    # a T5 name takes T5's layout (no sot, eos 1, pad 0) at its vocabulary,
    # not CLIP's (tests/test_torch_t5.py holds it against JAX)
    with pytest.warns(UserWarning, match="hashing"):
        t5 = port_tokenizers.build_tokenizer(None, text_encoder="t5-small")
    ids = t5("fold it, now")
    assert t5.vocab_size == 32128 and ids[4] == 1 and (ids[5:] == 0).all()


def _inputs(seed, b=2, n=300, h=3, d=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    mask = (rng.random((b, n)) > 0.3).astype(np.int32)
    mask[1, :] = 0                     # batch row 1: every key masked
    return q, k, v, mask


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check(out, ref, mask):
    out, ref = np.asarray(out), np.asarray(ref)
    degenerate = mask.sum(axis=1) == 0
    np.testing.assert_allclose(out[~degenerate], ref[~degenerate], atol=NORMAL_TOL)
    np.testing.assert_allclose(out[degenerate], ref[degenerate], atol=DEGENERATE_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_d32_plain_forward_matches_pallas(masked):
    """n = 275 (rgb_clip's fusion) is ragged over the Pallas q block."""
    q, k, v, mask = _inputs(1, n=275)
    jmask = jnp.asarray(mask) if masked else None
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                    interpret=True)
    out = fa.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask) if masked else None)
    _check(out.numpy(), ref, mask if masked else np.ones_like(mask))


def test_d32_plain_lse_matches_pallas_fwd_kernel():
    q, k, v, mask = _inputs(2)
    ref_out, ref_lse = jax_fwd_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        32 ** -0.5, None, 512, True)
    out, lse = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), _t(mask))
    _check(out.numpy(), ref_out, mask)
    ref_lse = np.asarray(ref_lse)
    assert (np.abs(lse.numpy() - ref_lse) <= NORMAL_TOL * np.maximum(1, np.abs(ref_lse))).all()


def test_d32_plain_backward_matches_pallas_vjp():
    q, k, v, mask = _inputs(3, n=275)
    do = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    jmask = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jmask, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    out, lse = fa.flash_attention_fwd_plain(tq, tk, tv, tm)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, _t(do))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=NORMAL_TOL,
                                   err_msg=f"d{name}")
    assert torch.count_nonzero(got[0][1]) == 0 and torch.count_nonzero(got[1][1]) == 0


def test_rgb_clip_fusion_head_dim_has_an_instance():
    """rgb_clip's shipped fusion (dim 512, 16 heads) runs at head dim 32,
    which the kernels are built for."""
    with torch.device("meta"):
        model = RGBOnly(32, True, text_encoder="ViT-B/16", depth=1, heads=16)
    attn = model.pick_place.fusion.transformer_encoder.layers[0][0].fn
    assert attn.dim_head == 32 and 32 in fa.KERNEL_HEAD_DIMS
