"""The port's transformer-decoder head and fusion variants against the JAX
package's modules, on the CPU, in float32.

- ``get_2d_sincos_pos_embed``, ``upsample2x`` and ``unpatchify`` equal to
  JAX's within 1e-6;
- ``TransformerDecoder`` (MAE head) and ``PickPlaceTransDecoder``,
  bimanual and unimanual, plain and with ``compute_mask``, ``detach_mask``
  and ``condition_place_on_pick``: the same output keys, every one within
  1e-4, and the gradient with respect to the inputs within 1e-4 (which
  holds ``detach_mask``'s cut);
- ``CrossAttention`` (flax ``MultiHeadDotProductAttention`` semantics,
  masked condition keys) and ``ConcatTransformer`` with registers, within
  1e-4.

JAX parameters are converted by the port's ``convert_bifold_inverse``
under the head's names and loaded ``strict=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.models import decoders as jax_decoders
from bifold_tpu.models.fusion import ConcatTransformer as JaxConcatTransformer
from bifold_tpu.models.fusion import CrossAttention as JaxCrossAttention
from bifold_tpu.models.layers import get_2d_sincos_pos_embed as jax_sincos
from bifold_tpu.models.pickplace import PickPlaceTransDecoder as JaxTransDecoder
from bifold_tpu_torch.models import decoders
from bifold_tpu_torch.models.convert import convert_bifold_inverse
from bifold_tpu_torch.models.fusion import ConcatTransformer, CrossAttention
from bifold_tpu_torch.models.layers import get_2d_sincos_pos_embed
from bifold_tpu_torch.models.pickplace import PickPlaceTransDecoder

TOL = 1e-4
EXACT_TOL = 1e-6
D, P, PATCH = 32, 16, 4            # 4 x 4 patches of 4 px: 16 x 16 heatmaps


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _load(module, params, where):
    """JAX ``params`` of the head's submodule ``where`` into ``module``."""
    state = convert_bifold_inverse({"pick_place": params})
    prefix = f"pick_place.{where}." if where else "pick_place."
    module.load_state_dict({k.removeprefix(prefix): torch.from_numpy(np.array(v))
                            for k, v in state.items()}, strict=True)
    return module


@pytest.mark.parametrize("dim, grid, cls", [(64, 4, True), (512, 24, True), (16, 3, False)])
def test_sincos_matches_jax(dim, grid, cls):
    got = get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
    want = jax_sincos(dim, grid, cls_token=cls)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT_TOL)


def test_upsample_and_unpatchify_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(decoders.upsample2x(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_decoders.upsample2x(jnp.asarray(x))),
                               rtol=0, atol=EXACT_TOL)
    for c in (1, 2):
        t = np.random.default_rng(c).standard_normal((2, 9, 4 * 4 * c)).astype(np.float32)
        np.testing.assert_allclose(
            decoders.unpatchify(torch.from_numpy(t), 4, c).numpy(),
            np.asarray(jax_decoders.unpatchify(jnp.asarray(t), 4, c)),
            rtol=0, atol=EXACT_TOL)


def test_transformer_decoder_matches_jax():
    kw = dict(dim=D, decoder_embed_dim=64, patch_size=PATCH, num_patches=P,
              decoder_num_heads=2, decoder_mlp_ratio=4, decoder_depth=2,
              out_channels=2)
    x = np.random.default_rng(1).standard_normal((2, P + 1, D)).astype(np.float32)
    jmod = jax_decoders.TransformerDecoder(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.key(0), jnp.asarray(x))["params"])
    want = jmod.apply({"params": params}, jnp.asarray(x))
    port = _load(decoders.TransformerDecoder(*kw.values()), {"pick_decoder": params},
                 "pick_decoder")
    assert "pos_embed" not in port.state_dict()         # a frozen constant
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == (2, P, PATCH * PATCH * 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    text = rng.standard_normal((b, 6, D)).astype(np.float32)
    ctx = rng.standard_normal((b, 2 * (P + 1), D)).astype(np.float32)
    image = rng.standard_normal((b, P + 1, D)).astype(np.float32)
    mask = np.ones((b, 6 + 3 * (P + 1)), np.int32)
    mask[1, 6:6 + P + 1] = 0                 # one padded context frame
    return text, ctx, image, mask


HEAD_CASES = [
    dict(is_bimanual=True), dict(is_bimanual=False),
    dict(is_bimanual=True, compute_mask=True),
    dict(is_bimanual=True, compute_mask=True, detach_mask=True),
    dict(is_bimanual=False, compute_mask=True, detach_mask=True),
    dict(is_bimanual=True, condition_place_on_pick=True),
    dict(is_bimanual=False, condition_place_on_pick=True, compute_mask=True),
]


@pytest.mark.parametrize("case", HEAD_CASES, ids=lambda c: "-".join(c) + str(c["is_bimanual"]))
def test_pick_place_transdecoder_matches_jax(case):
    fusion_kwargs = dict(heads=2, depth=1, mlp_ratio=2, dropout=0.0)
    dec = dict(decoder_embed_dim=64, decoder_num_heads=2, decoder_depth=2)
    text, ctx, image, mask = _inputs(2)
    jmod = JaxTransDecoder(dim=D, fusion_model="concat_transformer", num_patches=P,
                           patch_size=PATCH, fusion_kwargs=fusion_kwargs, **dec, **case)
    call = dict(modalities=[0, 1, 1], attention_masks=jnp.asarray(mask))
    jargs = (jnp.asarray(text), jnp.asarray(ctx), jnp.asarray(image))
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.key(3), *jargs, **call)["params"])

    def jax_total(args):
        out = jmod.apply({"params": params}, *args, **call)
        return sum(jnp.sum(v) for k, v in out.items() if k.endswith("_heatmap")), out

    (_, want), jgrads = jax.value_and_grad(jax_total, has_aux=True)(jargs)
    port = _load(PickPlaceTransDecoder(D, case["is_bimanual"], P, PATCH,
                                       "concat_transformer", fusion_kwargs,
                                       **dec, **{k: v for k, v in case.items()
                                                 if k != "is_bimanual"}),
                 params, "")
    targs = [torch.tensor(a, requires_grad=True) for a in (text, ctx, image)]
    got = port(*targs, modalities=[0, 1, 1], attention_masks=torch.from_numpy(mask))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v),
                                       atol=TOL, err_msg=k)
    sum(v.sum() for k, v in got.items() if k.endswith("_heatmap")).backward()
    for t, g in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=TOL)
    if case.get("compute_mask"):
        assert not any(k.endswith("pick_logits") for k in got)


def test_cross_attention_matches_jax():
    text, ctx, image, mask = _inputs(4)
    mask[0, :3] = 0                                   # masked text keys too
    jmod = JaxCrossAttention(dim=D, heads=2)
    jargs = (jnp.asarray(text), jnp.asarray(ctx), jnp.asarray(image))
    call = dict(modalities=[0, 1, 1], attention_masks=jnp.asarray(mask))
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.key(5), *jargs, **call)["params"])
    want, _ = jmod.apply({"params": params}, *jargs, **call)
    port = _load(CrossAttention(D, 2), {"fusion": params}, "fusion")
    assert tuple(port.cross_attention.query.kernel.shape) == (D, 2, D // 2)
    assert tuple(port.cross_attention.out.kernel.shape) == (2, D // 2, D)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (text, ctx, image)), modalities=[0, 1, 1],
                   attention_masks=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_concat_registers_match_jax():
    text, _, image, mask = _inputs(6)
    mask = mask[:, : 6 + P + 1].copy()
    mask[1, 2:4] = 0
    jmod = JaxConcatTransformer(dim=D, heads=2, depth=2, num_registers=3)
    jargs = (jnp.asarray(text), jnp.asarray(image))
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.key(7), *jargs, attention_masks=jnp.asarray(mask))["params"])
    want, _ = jmod.apply({"params": params}, *jargs, attention_masks=jnp.asarray(mask))
    port = _load(ConcatTransformer(D, 2, 2, num_registers=3), {"fusion": params},
                 "fusion")
    assert tuple(port.registers.shape) == (3, D)
    with torch.no_grad():
        got = port(torch.from_numpy(text), torch.from_numpy(image),
                   attention_masks=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
