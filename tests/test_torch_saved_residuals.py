"""The port's default LayerNorm and both GELUs save what JAX's custom VJPs
save (bifold_tpu/models/layers.py:52-101, 168-210), on numpy-seeded inputs:

- the forward is bitwise what the eager math written out op by op gives
  (kept here as the reference);
- the gradients agree with ``jax.vjp`` of ``_layer_norm``, ``gelu_tanh`` and
  ``gelu_exact`` in float32 within 1e-5;
- the tensors autograd keeps for the backward, seen through
  ``torch.autograd.graph.saved_tensors_hooks``, are JAX's residuals: x in
  the compute dtype, the f32 row mean and rstd and scale for the norm
  (mean and rstd within 1e-6: XLA and torch sum in other orders), x alone
  for a GELU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.models import layers as jl
from bifold_tpu_torch.models import layers as tl

GRAD_TOL = 1e-5
STAT_TOL = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _eager_layer_norm(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _eager_gelu_tanh(x):
    xf = x.float()
    t = torch.tanh(0.7978845608028654 * (xf + 0.044715 * xf ** 3))
    return (0.5 * xf * (1.0 + t)).to(x.dtype)


def _eager_gelu_exact(x):
    xf = x.float()
    return (xf * (0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0))))).to(x.dtype)


def _inputs(seed, shape=(3, 5, 64)):
    rng = np.random.default_rng(seed)
    x = (1.5 + 2.0 * rng.normal(size=shape)).astype(np.float32)
    x[1, 2] = 0.75                      # a constant row: variance clamps at 0
    return (x, (1.0 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32),
            (0.1 * rng.normal(size=shape[-1])).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _saved(fn):
    """(fn's result, every tensor autograd saved while running it)."""
    saved = []

    def pack(t):
        saved.append(t.detach().clone())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, saved


def _ln_module(scale, bias, eps, dtype):
    norm = tl.LayerNorm(scale.shape[0], eps, dtype)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    return norm


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_default_layer_norm_forward_is_the_eager_math(dtype, eps, monkeypatch):
    monkeypatch.delenv("BIFOLD_LN_KERNEL", raising=False)
    tdt = DTYPES[dtype][0]
    x, scale, bias, _ = _inputs(0)
    xt = torch.from_numpy(x).to(tdt)
    norm = _ln_module(scale, bias, eps, tdt)
    want = _eager_layer_norm(xt, norm.weight, norm.bias, eps)
    assert torch.equal(norm(xt), want)
    with torch.no_grad():
        assert torch.equal(norm(xt.requires_grad_()), want)


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_exact"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_forward_is_the_eager_math(name, dtype):
    eager = {"gelu_tanh": _eager_gelu_tanh, "gelu_exact": _eager_gelu_exact}[name]
    x = torch.from_numpy(_inputs(1)[0]).to(DTYPES[dtype][0])
    assert torch.equal(getattr(tl, name)(x), eager(x))


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_default_layer_norm_grads_match_jax(eps, monkeypatch):
    monkeypatch.delenv("BIFOLD_LN_KERNEL", raising=False)
    x, scale, bias, dy = _inputs(2)
    out, vjp = jax.vjp(lambda a, s, b: jl._layer_norm(a, s, b, eps),
                       jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ref = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    norm = _ln_module(scale, bias, eps, torch.float32)
    got = norm(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=GRAD_TOL)
    got.backward(torch.from_numpy(dy))
    for g, r in zip((xt.grad, norm.weight.grad, norm.bias.grad), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_exact"])
def test_gelu_grads_match_jax(name):
    x, _, _, dy = _inputs(3)
    out, vjp = jax.vjp(getattr(jl, name), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    got = getattr(tl, name)(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=GRAD_TOL)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=GRAD_TOL,
                               rtol=GRAD_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_default_layer_norm_saves_jax_residuals(dtype, monkeypatch):
    monkeypatch.delenv("BIFOLD_LN_KERNEL", raising=False)
    tdt, jdt = DTYPES[dtype]
    x, scale, bias, _ = _inputs(4)
    _, (jx, jmean, jrstd, jscale) = jl._layer_norm_fwd(
        jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias), 1e-6)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    norm = _ln_module(scale, bias, 1e-6, tdt)
    _, saved = _saved(lambda: norm(xt))
    assert [(tuple(t.shape), t.dtype) for t in saved] == [
        ((3, 5, 64), tdt), ((3, 5, 1), torch.float32), ((3, 5, 1), torch.float32),
        ((64,), torch.float32)]
    assert torch.equal(saved[0], xt.detach())
    np.testing.assert_array_equal(saved[0].float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    np.testing.assert_allclose(saved[1].numpy(), np.asarray(jmean), atol=STAT_TOL)
    np.testing.assert_allclose(saved[2].numpy(), np.asarray(jrstd), rtol=STAT_TOL)
    np.testing.assert_array_equal(saved[3].numpy(), np.asarray(jscale))


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_exact"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_saves_only_its_input(name, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _inputs(5)[0]
    _, res = getattr(jl, f"_{name}_fwd")(jnp.asarray(x).astype(jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    _, saved = _saved(lambda: getattr(tl, name)(xt))
    assert len(saved) == 1 and saved[0].dtype == tdt
    assert torch.equal(saved[0], xt.detach())
    np.testing.assert_array_equal(saved[0].float().numpy(),
                                  np.asarray(res.astype(jnp.float32)))
