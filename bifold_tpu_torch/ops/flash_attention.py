"""Flash attention forward (inference): hand-written CUDA kernel + plain twin.

Counterpart of the lse-free forward in bifold_tpu/ops/flash_attention.py
(``_online_softmax_loop`` + ``_fwd_kernel_infer``, :187-256, reached from
``_flash_with_vjp``'s primal at :722-744). Layout is the JAX one,
(B, N, H, D) in and out.

- :func:`flash_attention` is the wrapper. A tensor on the CPU takes the plain
  version; a CUDA tensor launches ``csrc/flash_fwd.cu`` or raises — there is
  no fallback. Each launch adds one to :data:`LAUNCHES` under its head dim.
- :func:`flash_attention_plain` is the same math in eager torch (f32 scores
  and softmax, -1e5 replacement fill, output in the input dtype). The CPU
  tests hold it against the JAX kernel; ``chip_smoke.py`` holds the CUDA
  kernel against it on the card.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into ``_build/`` at first
use (a plain C ABI loaded through ``ctypes``), never at import.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["flash_attention", "flash_attention_plain", "build", "LAUNCHES",
           "KERNEL_HEAD_DIMS"]

_NEG = -100000.0  # the XLA backend's fill value
KERNEL_HEAD_DIMS = (48, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel, keyed by head dim (one template instance each)
LAUNCHES: collections.Counter = collections.Counter()

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lib = None
_lib_lock = threading.Lock()


def flash_attention_plain(q, k, v, key_mask=None, *, scale=None):
    """The kernel's function in eager torch: scores in f32 from the f32-scaled
    q, masked scores replaced by -1e5, f32 softmax over the true keys,
    output cast to the input dtype. An all-masked row averages v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if key_mask is not None:
        s = s.masked_fill(key_mask[:, None, None, :] == 0, _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                      # (b, h, q)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / l.clamp_min(1e-30).permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the flash "
            "kernel is built from bifold_tpu_torch/csrc/flash_fwd.cu at first use")
    return found


def build() -> Path:
    """Compile ``csrc/flash_fwd.cu`` for sm_90a into ``_build/`` (skipped
    when a library built from the same source bytes is there) and return its
    path."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    out = _BUILD_DIR / f"libflash_fwd-{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    tmp.replace(out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.bifold_flash_fwd_infer
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                              ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.bifold_cuda_error_string.argtypes = [ctypes.c_int]
            lib.bifold_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


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
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is not on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim is not "
                             "contiguous")
    if key_mask is not None:
        if (key_mask.dtype != torch.int32 or key_mask.device != q.device
                or tuple(key_mask.shape) != (b, k.shape[1])
                or not key_mask.is_contiguous()):
            raise ValueError("flash_attention: key_mask must be a contiguous "
                             f"int32 (B, nk) tensor on {q.device}")
    if b * h > 65535 or min(b, nq, k.shape[1], h) == 0:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} is outside "
                         "the kernel's grid (0 < B*H <= 65535, N > 0)")


def flash_attention(q, k, v, key_mask=None, *, scale=None):
    """Attention over (B, N, H, D) -> (B, N, H, D), forward only.

    On the CPU this is :func:`flash_attention_plain`. On the card it launches
    the CUDA kernel (head dim 48 or 64, float32 or bfloat16, head dim
    contiguous, ``key_mask`` a contiguous int32 (B, nk) tensor or None) on the
    current stream, and raises on anything else."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, key_mask)
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.bifold_flash_fwd_infer(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            out.data_ptr(), b, nq, k.shape[1], h, d, strides, float(scale),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.bifold_cuda_error_string(err).decode())
    LAUNCHES[d] += 1
    return out
