"""Attention entry point: one function, flash-kernel or math backend.

Counterpart of bifold_tpu/ops/attention.py:29-103. Every transformer stack of
the port calls :func:`dot_product_attention`. Layout is (B, N, H, Dh).

``key_mask`` (B, N) masks attention *to* keys; ``legacy_query_mask``
reproduces the reference's fill along the query axis. Masked logits are
replaced by -1e5, and the softmax is always taken in float32.

Backends:

- ``"math"`` (the JAX package's ``"xla"``, accepted as an alias): einsum
  scores in the input dtype, f32 softmax cast back, einsum with v;
- ``"flash"``: the flash kernels of :mod:`bifold_tpu_torch.ops.flash_attention`
  (CUDA on the card, their plain versions on the CPU). A call that autograd
  will differentiate (grad enabled, q, k or v requiring grad) goes through
  :func:`flash_attention_train` (forward with lse, fused backward); any
  other call through the lse-free inference kernel, as JAX's
  ``_flash_with_vjp`` runs its primal on ``_fwd_infer_cp`` and its VJP
  forward on ``_fwd_cp``;
- ``"auto"``: the kernel for a CUDA tensor when the call is non-causal,
  asks for no weights, has no legacy query mask, equal q/k lengths and
  N >= 256; the math path otherwise. That is JAX's choice, by shape alone:
  such a call with a head dim or dtype the kernels have no instance for
  raises (:data:`~bifold_tpu_torch.ops.flash_attention.KERNEL_HEAD_DIMS`)
  rather than taking the math path, so a missing instance never hides.

``BIFOLD_ATTN_BACKEND`` overrides ``backend`` for the calls the kernel
supports, as in the JAX package.
"""

from __future__ import annotations

import os

import torch

from bifold_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_train,
)

__all__ = ["dot_product_attention"]

_NEG = -100000.0
_FLASH_MIN_TOKENS = 256  # flash pays off once N is past a few hundred tokens


def _math_attention(q, k, v, key_mask, legacy_query_mask, scale, causal):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if legacy_query_mask is not None:
        logits = logits.masked_fill(legacy_query_mask[:, None, :, None] == 0, _NEG)
    if key_mask is not None:
        logits = logits.masked_fill(key_mask[:, None, None, :] == 0, _NEG)
    if causal:
        nq, nk = logits.shape[-2], logits.shape[-1]
        tri = torch.ones((nq, nk), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tri, _NEG)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), probs


def dot_product_attention(q, k, v, key_mask=None, *, legacy_query_mask=None,
                          causal: bool = False, scale: float | None = None,
                          backend: str = "auto", return_weights: bool = False):
    """Multi-head attention over (B, N, H, Dh) tensors (see module doc)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    unsupported = (causal or return_weights or legacy_query_mask is not None
                   or q.shape[1] != k.shape[1])
    env_backend = os.environ.get("BIFOLD_ATTN_BACKEND")
    if env_backend:
        backend = "math" if (env_backend == "flash" and unsupported) else env_backend
    if backend not in ("auto", "flash", "math", "xla"):
        raise ValueError(f"unknown attention backend {backend!r}")

    use_flash = False
    if backend == "flash":
        if unsupported:
            raise NotImplementedError(
                "backend='flash' does not support causal / return_weights / "
                "legacy_query_mask / cross-length attention; use backend="
                "'math' or 'auto' for these calls")
        use_flash = True
    elif backend == "auto" and not unsupported:
        use_flash = q.is_cuda and q.shape[1] >= _FLASH_MIN_TOKENS

    if use_flash:
        mask = None if key_mask is None else key_mask.to(torch.int32).contiguous()
        grad = torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)
        out = (flash_attention_train if grad else flash_attention)(
            q, k, v, mask, scale=scale)
        return (out, None) if return_weights else out

    out, probs = _math_attention(q, k, v, key_mask, legacy_query_mask, scale,
                                 causal)
    return (out, probs) if return_weights else out
