"""LayerNorm: hand-written CUDA kernels, their plain twins, the mode switch.

Counterpart of bifold_tpu/ops/layer_norm.py. Shapes are the JAX ones: rows
(..., C), stats (..., 1) float32, dscale and dbias (C,) float32.

- :func:`ln_forward` — row LayerNorm with the fast variance -> (out, mean,
  rstd) (``_fwd_kernel``, :141): ``csrc/layer_norm.cu`` ``bifold_ln_fwd``.
- :func:`ln_backward` — dx, dscale, dbias from the saved input and stats
  (``_bwd_kernel``, :199): ``bifold_ln_bwd``.
- :func:`fused_ln_forward` — s = x + delta rounded to x's dtype, then the
  LayerNorm of s -> (s, out, mean, rstd) (``_fused_fwd_kernel``, :271):
  ``bifold_fused_ln_fwd``.
- :func:`fused_ln_backward` — as :func:`ln_backward` on s, with the residual
  stream's cotangent added to dx (``_fused_bwd_kernel``, :322):
  ``bifold_fused_ln_bwd``.

Each wrapper takes its plain version (``*_plain``, the same math in eager
torch, written out rather than differentiated) for a tensor on the CPU; a
CUDA tensor launches the kernel or raises — there is no fallback. Each
launch adds one to :data:`LAUNCHES` under ``ln_fwd``, ``ln_bwd``,
``fused_ln_fwd`` or ``fused_ln_bwd``.

``BIFOLD_LN_KERNEL`` (read per call, as the JAX package reads it at trace
time) selects where the model uses them: ``pallas`` sends every LayerNorm
whose width is a multiple of 128 through :func:`ln_forward` /
:func:`ln_backward`; ``fused`` also moves every residual add of the
pre-norm stacks into :func:`fused_ln_forward` (see
``models/layers.py:Transformer``); anything else, and unset, is the default
eager LayerNorm. The name ``pallas`` is kept from the JAX package so that
one setting means one routing in both.
"""

from __future__ import annotations

import collections
import ctypes
import os

import torch

from bifold_tpu_torch.ops._cuda import DTYPE_CODES, call, launch, on_card

__all__ = ["ln_forward", "ln_backward", "fused_ln_forward",
           "fused_ln_backward", "ln_forward_plain", "ln_backward_plain",
           "fused_ln_forward_plain", "fused_ln_backward_plain", "ln_mode",
           "use_kernel_ln", "backward_grid", "LAUNCHES", "MAX_COLS"]

MAX_COLS = 1024                # csrc/layer_norm.cu kMaxCols
# (device index, kernel, dtype code, C) -> (SMs, backward blocks per SM,
# warps per block)
_RESIDENT: dict = {}

# launches of the CUDA kernels, keyed by kernel
LAUNCHES: collections.Counter = collections.Counter()


def ln_mode() -> str:
    """'' (the default eager LayerNorm), 'pallas' (the LayerNorm kernels) or
    'fused' (the kernels, with the residual adds inside them)."""
    mode = os.environ.get("BIFOLD_LN_KERNEL", "").lower()
    return mode if mode in ("pallas", "fused") else ""


def use_kernel_ln(c: int) -> bool:
    """True when a LayerNorm of width ``c`` takes the kernels: a mode is set
    and ``c`` is a multiple of 128 (a choice by shape, as in the JAX
    package; other widths keep the eager LayerNorm in every mode)."""
    return c % 128 == 0 and ln_mode() != ""


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def ln_forward_plain(x, scale, bias, eps):
    """(out [x.dtype], mean (..., 1) f32, rstd (..., 1) f32): statistics in
    f32 with the fast variance E[x^2] - E[x]^2 clamped at 0."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    return (y * scale.float() + bias.float()).to(x.dtype), mean, rstd


def _backward_f32(x, dy, mean, rstd, scale):
    xhat = (x.float() - mean) * rstd
    dyf = dy.float()
    lead = tuple(range(dy.dim() - 1))
    dscale = (dyf * xhat).sum(dim=lead)
    dbias = dyf.sum(dim=lead)
    dxhat = dyf * scale.float()
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx, dscale, dbias


def ln_backward_plain(x, dy, mean, rstd, scale):
    """(dx [x.dtype], dscale (C,) f32, dbias (C,) f32) from the saved input
    and row stats, all in f32."""
    dx, dscale, dbias = _backward_f32(x, dy, mean, rstd, scale)
    return dx.to(x.dtype), dscale, dbias


def fused_ln_forward_plain(x, delta, scale, bias, eps):
    """(s, out, mean, rstd): s = x + delta in f32 rounded to x's dtype, then
    :func:`ln_forward_plain` of that rounded s."""
    s = (x.float() + delta.float()).to(x.dtype)
    return (s, *ln_forward_plain(s, scale, bias, eps))


def fused_ln_backward_plain(s, dy, ds_out, mean, rstd, scale):
    """(ds [s.dtype], dscale, dbias): :func:`ln_backward_plain` on s with the
    residual stream's cotangent ``ds_out`` added in f32 before the cast;
    ds is the gradient of both x and delta."""
    dx, dscale, dbias = _backward_f32(s, dy, mean, rstd, scale)
    return (dx + ds_out.float()).to(s.dtype), dscale, dbias


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _rows(fn_name, x, *others):
    """``x`` and ``others`` (same shape and dtype as x) as contiguous (R, C)
    views, checked against what the kernels take."""
    if (x.dim() < 1 or x.shape[-1] % 128 or x.shape[-1] > MAX_COLS
            or not x.numel()):
        raise ValueError(f"{fn_name}: shape {tuple(x.shape)}; the kernel takes "
                         f"(..., C) with C a multiple of 128 up to {MAX_COLS} "
                         "and at least one row")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{fn_name}: dtype {x.dtype}; the kernel takes float32 "
                        "or bfloat16")
    c, out = x.shape[-1], []
    for t in (x, *others):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{fn_name}: row inputs differ in shape, dtype or "
                             f"device ({tuple(t.shape)} {t.dtype} {t.device} "
                             f"against {tuple(x.shape)} {x.dtype} {x.device})")
        t = t.reshape(-1, c).contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"{fn_name}: a row input is not 16-byte aligned")
        out.append(t)
    return out


def _params(fn_name, x, *params):
    c = x.shape[-1]
    dtype = params[0].dtype
    for p in params:
        if (tuple(p.shape) != (c,) or p.dtype != dtype or p.dtype not in
                DTYPE_CODES or p.device != x.device or not p.is_contiguous()
                or p.data_ptr() % 16):
            raise ValueError(f"{fn_name}: scale and bias must be contiguous "
                             f"aligned float32 or bfloat16 ({c},) tensors on "
                             f"{x.device}, of one dtype")
    return DTYPE_CODES[dtype]


def _stats(fn_name, x, mean, rstd):
    want = (*x.shape[:-1], 1)
    out = []
    for t in (mean, rstd):
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or t.device != x.device):
            raise ValueError(f"{fn_name}: mean and rstd must be float32 "
                             f"{want} tensors on {x.device}")
        out.append(t.reshape(-1).contiguous())
    return out


def ln_forward(x, scale, bias, eps):
    """(..., C) -> (out (..., C) [x.dtype], mean (..., 1) f32, rstd (..., 1)
    f32). On the CPU :func:`ln_forward_plain`; on the card the kernel
    (float32 or bfloat16 rows, C a multiple of 128 up to 1024, scale and
    bias float32 or bfloat16) on the current stream, or it raises."""
    if not on_card("ln_forward", x):
        return ln_forward_plain(x, scale, bias, eps)
    (x2,) = _rows("ln_forward", x)
    pdt = _params("ln_forward", x, scale, bias)
    r, c = x2.shape
    out = torch.empty_like(x2)
    mean = torch.empty(r, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    launch("layer_norm", "bifold_ln_fwd", x.device, x2.data_ptr(),
           scale.data_ptr(), bias.data_ptr(), out.data_ptr(), mean.data_ptr(),
           rstd.data_ptr(), r, c, float(eps), DTYPE_CODES[x.dtype], pdt)
    LAUNCHES["ln_fwd"] += 1
    stat = (*x.shape[:-1], 1)
    return out.reshape(x.shape), mean.reshape(stat), rstd.reshape(stat)


def fused_ln_forward(x, delta, scale, bias, eps):
    """(..., C) x 2 -> (s = x + delta [x.dtype], out = LN(s) [x.dtype],
    mean (..., 1) f32, rstd (..., 1) f32). On the CPU
    :func:`fused_ln_forward_plain`; on the card the fused kernel (delta of
    x's shape and dtype) or it raises."""
    if not on_card("fused_ln_forward", x):
        return fused_ln_forward_plain(x, delta, scale, bias, eps)
    x2, d2 = _rows("fused_ln_forward", x, delta)
    pdt = _params("fused_ln_forward", x, scale, bias)
    r, c = x2.shape
    s = torch.empty_like(x2)
    out = torch.empty_like(x2)
    mean = torch.empty(r, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    launch("layer_norm", "bifold_fused_ln_fwd", x.device, x2.data_ptr(),
           d2.data_ptr(), scale.data_ptr(), bias.data_ptr(), s.data_ptr(),
           out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), r, c, float(eps),
           DTYPE_CODES[x.dtype], pdt)
    LAUNCHES["fused_ln_fwd"] += 1
    stat = (*x.shape[:-1], 1)
    return (s.reshape(x.shape), out.reshape(x.shape), mean.reshape(stat),
            rstd.reshape(stat))


def backward_grid(sms: int, per_sm: int, warps: int, rows: int) -> int:
    """Blocks of one backward launch: all resident at once (at most ``sms``
    x ``per_sm``), ``warps`` per block, each warp a contiguous run of rows.
    The fewest blocks that give no warp more rows than the full card
    would, so that each warp takes the same number of rows or one fewer,
    and the column sums read no more partial rows than needed."""
    if sms < 1 or per_sm < 1 or warps < 1 or rows < 1:
        raise ValueError(f"backward_grid: {sms} SMs, {per_sm} blocks per SM, "
                         f"{warps} warps per block, {rows} rows")
    per_warp = -(-rows // (sms * per_sm * warps))
    return -(-rows // (warps * per_warp))


def _resident(device, kernel, dtype_code, c):
    """(SM count, resident blocks per SM, warps per block) of the backward
    instance for ``c`` columns and ``dtype_code`` on ``device``, asked of
    the built kernel once and cached. The query also sets the instance's
    shared-memory limit on the device, which its launches need, so every
    launch asks here first."""
    key = (device.index, kernel, dtype_code, c)
    if key not in _RESIDENT:
        per_sm, sms, warps = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        call("layer_norm", "bifold_ln_bwd_occupancy", device, c, dtype_code,
             int(kernel == "fused_ln_bwd"), ctypes.byref(per_sm), ctypes.byref(sms),
             ctypes.byref(warps))
        _RESIDENT[key] = (sms.value, per_sm.value, warps.value)
    return _RESIDENT[key]


def _backward_on_card(fn_name, kernel, x, dy, ds_out, mean, rstd, scale):
    rows = _rows(fn_name, x, *((dy,) if ds_out is None else (dy, ds_out)))
    mean2, rstd2 = _stats(fn_name, x, mean, rstd)
    pdt = _params(fn_name, x, scale)
    r, c = rows[0].shape
    code = DTYPE_CODES[x.dtype]
    blocks = backward_grid(*_resident(x.device, kernel, code, c), r)
    dx = torch.empty_like(rows[0])
    partial = torch.empty((blocks, 2, c), dtype=torch.float32, device=x.device)
    dparams = torch.empty((2, c), dtype=torch.float32, device=x.device)
    launch("layer_norm", f"bifold_{kernel}", x.device,
           *[t.data_ptr() for t in rows], mean2.data_ptr(), rstd2.data_ptr(),
           scale.data_ptr(), dx.data_ptr(), partial.data_ptr(),
           dparams[0].data_ptr(), dparams[1].data_ptr(),
           r, c, blocks, code, pdt)
    LAUNCHES[kernel] += 1
    return dx.reshape(x.shape), dparams[0], dparams[1]


def ln_backward(x, dy, mean, rstd, scale):
    """(dx (..., C) [x.dtype], dscale (C,) f32, dbias (C,) f32) from the
    saved input, the output cotangent and the row stats. On the CPU
    :func:`ln_backward_plain`; on the card one launch of the backward
    kernel (dy of x's shape and dtype) or it raises. dscale and dbias are
    deterministic: summed in an order fixed by the grid, no atomics."""
    if not on_card("ln_backward", x):
        return ln_backward_plain(x, dy, mean, rstd, scale)
    return _backward_on_card("ln_backward", "ln_bwd", x, dy, None, mean, rstd,
                             scale)


def fused_ln_backward(s, dy, ds_out, mean, rstd, scale):
    """Backward of :func:`fused_ln_forward`: (ds [s.dtype], dscale, dbias),
    ds = ds_out + dLN(s)/ds · dy, the gradient of both x and delta. On the
    CPU :func:`fused_ln_backward_plain`; on the card the fused backward
    kernel or it raises."""
    if not on_card("fused_ln_backward", s):
        return fused_ln_backward_plain(s, dy, ds_out, mean, rstd, scale)
    return _backward_on_card("fused_ln_backward", "fused_ln_bwd", s, dy, ds_out,
                             mean, rstd, scale)
