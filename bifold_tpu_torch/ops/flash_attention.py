"""Flash attention: hand-written CUDA kernels, their plain twins, autograd.

Counterpart of bifold_tpu/ops/flash_attention.py. Layout is the JAX one,
(B, N, H, D) in and out; lse and delta are float32 (B, H, Nq).

- :func:`flash_attention` — forward only, no lse (``_fwd_kernel_infer``,
  :250): ``csrc/flash_fwd.cu`` ``bifold_flash_fwd_infer``. Serving and
  every call that needs no gradient take it.
- :func:`flash_attention_fwd` — forward plus the f32 row logsumexp
  (``_fwd_kernel``, :241): ``csrc/flash_fwd.cu`` ``bifold_flash_fwd_lse``.
- :func:`flash_attention_bwd` — the fused backward -> dq, dk, dv
  (``_dqkv_kernel``, :360): ``csrc/flash_bwd.cu``. delta = rowsum(dO * O)
  is a torch op in f32, as JAX computes it outside its kernel (:499-502).
- :func:`flash_attention_train` — the ``torch.autograd.Function`` over the
  last two (``_flash_with_vjp``'s forward/backward rules, :722-744).

Each wrapper takes its plain version (``*_plain``, the same math in eager
torch) for a tensor on the CPU; a CUDA tensor launches the kernel or raises
— there is no fallback. Each launch adds one to :data:`LAUNCHES` under
``"<kernel>_d<head dim>"`` for a bfloat16 instance and
``"<kernel>_d<head dim>_f32"`` for a float32 one: ``fwd_infer``,
``fwd_lse`` and ``bwd`` (one backward call enqueues its dk/dv and dq
kernels together), and to :data:`SHAPES` under (that key, the (B, N, H, D)
shape of q), which shows the heads a tensor-parallel rank launches at. The
CPU tests
hold the plain versions against the JAX kernels; ``chip_smoke.py`` holds the
CUDA kernels against the plain versions on the card.

Both dtypes run on the tensor cores with ``mma.sync`` and f32
accumulation: bfloat16 inputs as bf16 operands (P and dS rounded to bf16
before their products), float32 inputs as 3xTF32 (each operand split into
TF32 hi and lo, a.b = hi.hi + hi.lo + lo.hi: f32's accuracy, the precision
reference; never a single TF32 pass). Both are instanced at
head dims 32 (rgb_clip's fusion stack and the transformer decoder), 48 (the
flagship's fusion stack) and 64 (the SigLIP vision tower),
:data:`KERNEL_HEAD_DIMS`; another head dim raises on the card. On the card
q, k and v must start on 16 bytes and have (batch, token, head) strides
that are multiples of 8 elements, as the fused ``to_qkv`` views do
(the kernels' 16-byte ``cp.async`` rows need 8 bf16 or 4 f32 elements;
their C entry points refuse less); anything else raises.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into ``_build/`` at
first use (plain C ABIs loaded through ``ctypes``), never at import, by
:mod:`bifold_tpu_torch.ops._cuda`; ``build``, ``ptxas_report`` and
``SOURCES`` (every ``csrc`` source) are re-exported here.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from bifold_tpu_torch.ops._cuda import (DTYPE_CODES, SOURCES, build, launch,
                                         on_card, ptxas_report)

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_train", "build",
           "ptxas_report", "SOURCES", "LAUNCHES", "SHAPES", "KERNEL_HEAD_DIMS"]

_NEG = -100000.0  # the XLA backend's fill value
KERNEL_HEAD_DIMS = (32, 48, 64)

# launches of the CUDA kernels, keyed "<kernel>_d<head dim>" (bfloat16) or
# "<kernel>_d<head dim>_f32"
LAUNCHES: collections.Counter = collections.Counter()
# the same launches keyed (key, q's shape)
SHAPES: collections.Counter = collections.Counter()


def _count(name: str, q: torch.Tensor) -> None:
    key = name + ("_f32" if q.dtype == torch.float32 else "")
    LAUNCHES[key] += 1
    SHAPES[key, tuple(q.shape)] += 1


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, key_mask, scale):
    """f32 scores (b, h, q, k) from the f32-scaled q, masked ones replaced."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if key_mask is not None:
        s = s.masked_fill(key_mask[:, None, None, :] == 0, _NEG)
    return s


def flash_attention_fwd_plain(q, k, v, key_mask=None, *, scale=None):
    """The forward kernels' function in eager torch: scores in f32 from the
    f32-scaled q, masked scores replaced by -1e5, f32 softmax over the true
    keys, output cast to the input dtype; plus lse = m + log(max(l, 1e-30))
    in f32, (B, H, Nq). An all-masked row averages v, and its lse is
    -1e5 + log(nk)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, key_mask, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1).clamp_min(1e-30)                     # (b, h, q)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / l.permute(0, 2, 1)[..., None]
    return out.to(q.dtype), m[..., 0] + torch.log(l)


def flash_attention_plain(q, k, v, key_mask=None, *, scale=None):
    """:func:`flash_attention_fwd_plain` without the lse (the inference
    kernel's function)."""
    return flash_attention_fwd_plain(q, k, v, key_mask, scale=scale)[0]


def _delta(out, do):
    """rowsum(dO * O) in f32, (B, H, Nq) contiguous."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, key_mask, out, lse, do, *, scale=None):
    """The backward kernels' function in eager torch, written out as they
    compute it (not through autograd): s = (q.k) * scale in f32 with masked
    scores replaced by -1e5, p = exp(s - lse), dp = dO.v,
    ds = p * (dp - delta) * scale set to 0 on masked keys; dq = ds.k,
    dk = ds^T.q, dv = p^T.dO, all in f32, cast to q's, k's and v's dtype.
    On a row whose keys are all masked dq and dk are exactly 0 and dv gets
    the row's uniform 1/nk mass."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    dead = None if key_mask is None else (key_mask == 0)[:, None, None, :]
    if dead is not None:
        s = s.masked_fill(dead, _NEG)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - _delta(out, do)[..., None]) * scale
    if dead is not None:
        ds = ds.masked_fill(dead, 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda_inputs(q, k, v, key_mask):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, N, H, D) with k and v alike")
    b, nq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError("flash_attention: q and k/v differ in B, H or D")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} has no kernel "
                         f"(built for {KERNEL_HEAD_DIMS})")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is not on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim is not "
                             "contiguous")
        # the kernels copy rows by 16-byte cp.async (8 bf16 or 4 f32
        # elements); both dtypes are held to 8
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} must start on 16 "
                             "bytes and have (batch, token, head) strides "
                             "that are multiples of 8 elements; got "
                             f"{t.data_ptr() % 16} bytes past, strides "
                             f"{t.stride()[:3]}")
    if key_mask is not None:
        if (key_mask.dtype != torch.int32 or key_mask.device != q.device
                or tuple(key_mask.shape) != (b, k.shape[1])
                or not key_mask.is_contiguous()):
            raise ValueError("flash_attention: key_mask must be a contiguous "
                             f"int32 (B, nk) tensor on {q.device}")
    if b * h > 65535 or min(b, nq, k.shape[1], h) == 0:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} is outside "
                         "the kernel's grid (0 < B*H <= 65535, N > 0)")


def _strides(q, k, v):
    return (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                *v.stride()[:3])


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, key_mask=None, *, scale=None):
    """Attention over (B, N, H, D) -> (B, N, H, D), forward only, no lse.

    On the CPU this is :func:`flash_attention_plain`. On the card it launches
    the inference kernel (head dim 32, 48 or 64, float32 or bfloat16, head dim
    contiguous, ``key_mask`` a contiguous int32 (B, nk) tensor or None) on the
    current stream, and raises on anything else. Its output carries no
    gradient: differentiable calls go through :func:`flash_attention_train`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not on_card("flash_attention", q):
        return flash_attention_plain(q, k, v, key_mask, scale=scale)
    return _forward_on_card(q, k, v, key_mask, scale, with_lse=False)[0]


def flash_attention_fwd(q, k, v, key_mask=None, *, scale=None):
    """(out, lse): the forward of :func:`flash_attention` plus the f32 row
    logsumexp, (B, H, Nq). Same inputs and rules as
    :func:`flash_attention`; on the card, the lse kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not on_card("flash_attention_fwd", q):
        return flash_attention_fwd_plain(q, k, v, key_mask, scale=scale)
    return _forward_on_card(q, k, v, key_mask, scale, with_lse=True)


def _forward_on_card(q, k, v, key_mask, scale, *, with_lse):
    """Launch the inference (``with_lse`` False; lse None) or the lse
    instance of ``csrc/flash_fwd.cu`` -> (out, lse)."""
    _check_cuda_inputs(q, k, v, key_mask)
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
            out.data_ptr()] + ([lse.data_ptr()] if with_lse else [])
    kernel = "fwd_lse" if with_lse else "fwd_infer"
    launch("flash_fwd", f"bifold_flash_{kernel}", q.device, *ptrs, b, nq,
           k.shape[1], h, d, _strides(q, k, v), float(scale),
           DTYPE_CODES[q.dtype])
    _count(f"{kernel}_d{d}", q)
    return out, lse


def flash_attention_bwd(q, k, v, key_mask, out, lse, do, *, scale=None):
    """(dq, dk, dv) of attention from the forward's ``out`` and ``lse`` and
    the output cotangent ``do``, in q's, k's and v's dtype and layout. On the
    CPU this is :func:`flash_attention_bwd_plain`; on the card it computes
    delta = rowsum(dO * O) in f32 and launches the backward kernels (``out``
    as :func:`flash_attention_fwd` returns it, ``do`` made contiguous)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not on_card("flash_attention_bwd", q):
        return flash_attention_bwd_plain(q, k, v, key_mask, out, lse, do,
                                         scale=scale)
    _check_cuda_inputs(q, k, v, key_mask)
    b, nq, h, d = q.shape
    do = do.contiguous()
    for name, t in (("out", out), ("do", do)):
        if (tuple(t.shape) != (b, nq, h, d) or t.dtype != q.dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous {q.dtype} (B, Nq, H, D) tensor")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, nq)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         "float32 (B, H, Nq) tensor")
    delta = _delta(out, do)
    dq = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    launch("flash_bwd", "bifold_flash_bwd", q.device, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), _ptr(key_mask), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), b, nq, k.shape[1], h, d, _strides(q, k, v),
           float(scale), DTYPE_CODES[q.dtype])
    _count(f"bwd_d{d}", q)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward with lse saves
    (q, k, v, mask, out, lse), the backward runs the fused backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        out, lse = flash_attention_fwd(q, k, v, key_mask, scale=scale)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_mask, out, lse, do,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, key_mask=None, *, scale=None):
    """:func:`flash_attention` with gradients for q, k and v (see
    :class:`FlashAttention`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, key_mask, float(scale))
