"""The port's layers against the flax modules of the JAX package, on the same
weights (the flax params converted to the torch layout) and the same
numpy-seeded inputs, in float32 at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.models import decoders as jdec
from bifold_tpu.models import layers as jl
from bifold_tpu.models.lora import LoRADense
from bifold_tpu_torch.models import decoders as tdec
from bifold_tpu_torch.models import layers as tl
from bifold_tpu_torch.models.lora import LoRALinear

TOL = 1e-5


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(module, x, seed=0, **kw):
    params = module.init(jax.random.key(seed), jnp.asarray(x), **kw)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _randomize(params, seed):
    """Replace every leaf with seeded noise so zero-init leaves (biases,
    LoRA B) and unit LayerNorm scales are exercised too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (0.1 * rng.normal(size=p.shape)).astype(np.float32), params)


def _load(module, state):
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in state.items()}, strict=True)
    return module


def _close(out, ref):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm(eps):
    x = 3.0 + _x(0, (2, 7, 64))          # an offset mean stresses E[x^2]-E[x]^2
    mod = jl.LayerNorm(epsilon=eps)
    p = _randomize(_init(mod, x), 1)
    ref = mod.apply({"params": p}, jnp.asarray(x))
    out = _load(tl.LayerNorm(64, eps), {"weight": p["scale"], "bias": p["bias"]})(
        torch.from_numpy(x))
    _close(out, ref)


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_exact"])
def test_gelu(name):
    x = 3.0 * _x(2, (4, 1000))
    _close(getattr(tl, name)(torch.from_numpy(x)),
           getattr(jl, name)(jnp.asarray(x)))


def test_lora_linear():
    x = _x(3, (2, 5, 32))
    mod = LoRADense(features=48, rank=4, alpha=16.0)
    p = _randomize(_init(mod, x), 4)
    ref = mod.apply({"params": p}, jnp.asarray(x))
    tmod = _load(LoRALinear(32, 48, rank=4, alpha=16.0), {
        "base_layer.weight": p["base"]["kernel"].T, "base_layer.bias": p["base"]["bias"],
        "lora_A.siglip_adapter.weight": p["lora_a"].T,
        "lora_B.siglip_adapter.weight": p["lora_b"].T})
    _close(tmod(torch.from_numpy(x)), ref)


def _linear(p):
    out = {"weight": p["kernel"].T}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _prefixed(prefix, d):
    return {f"{prefix}.{k}": v for k, v in d.items()}


def test_mha_fused():
    """The fusion stack's bias-free to_qkv with a key mask."""
    x = _x(5, (2, 40, 64))
    mask = np.ones((2, 40), np.int32)
    mask[1, 10:30] = 0
    mod = jl.MultiHeadAttention(dim=64, heads=4, fused_qkv=True, qkv_bias=False)
    p = _randomize(_init(mod, x), 6)
    ref = mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    tmod = _load(tl.MultiHeadAttention(64, 4, fused_qkv=True), {
        "to_qkv.weight": p["to_qkv"]["kernel"].T,
        **_prefixed("to_out.0", _linear(p["out_proj"]))})
    _close(tmod(torch.from_numpy(x), torch.from_numpy(mask)), ref)


@pytest.mark.parametrize("lora", [False, True])
def test_mha_separate(lora):
    """The towers' biased q/k/v/out projections, LoRA on q and v."""
    x = _x(7, (2, 20, 64))
    mod = jl.MultiHeadAttention(dim=64, heads=4, lora_rank=4 if lora else 0,
                                lora_alpha=32.0)
    p = _randomize(_init(mod, x), 8)
    ref = mod.apply({"params": p}, jnp.asarray(x))
    state = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        if "base" in p[name]:
            state.update(_prefixed(f"{name}.base_layer", _linear(p[name]["base"])))
            state[f"{name}.lora_A.siglip_adapter.weight"] = p[name]["lora_a"].T
            state[f"{name}.lora_B.siglip_adapter.weight"] = p[name]["lora_b"].T
        else:
            state.update(_prefixed(name, _linear(p[name])))
    tmod = _load(tl.MultiHeadAttention(64, 4, lora_rank=4 if lora else 0,
                                       lora_alpha=32.0), state)
    _close(tmod(torch.from_numpy(x)), ref)


def test_conv_decoder():
    x = _x(9, (2, 4, 4, 64))
    mod = jdec.ConvDecoder(64, 1)
    p = _randomize(_init(mod, x), 10)
    ref = mod.apply({"params": p}, jnp.asarray(x))
    state = {}
    for j, slot in enumerate((0, 2, 4, 6, 8)):
        state[f"decoder_net.{slot}.weight"] = p[f"conv{j}"]["kernel"].T[:, :, None, None]
        state[f"decoder_net.{slot}.bias"] = p[f"conv{j}"]["bias"]
    out = _load(tdec.ConvDecoder(64, 1), state)(torch.from_numpy(x))
    assert out.shape == (2, 64, 64, 1)
    _close(out, ref)
