"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with plain C entry points, at first use (never at
import), into the git-ignored ``bifold_tpu_torch/_build/``, named by a hash
of the source and ``csrc/*.cuh`` bytes so that an edited source is rebuilt.
The compiler's ``-Xptxas -v`` report (registers, shared memory and spill
bytes of every kernel instance) is kept beside the library and returned by
:func:`ptxas_report`. The library is
loaded with ``ctypes``; :data:`_SIGNATURES` gives every entry point's
argument types (pointers and the stream as ``c_void_p``, so that ctypes
never cuts a pointer to 32 bits). Every entry point takes the stream as its
last argument (a query, none) and returns a ``cudaError_t``;
:func:`launch` passes the device's current stream, and it and :func:`call`
raise on a nonzero error. :func:`on_card` is
the wrappers' one rule for choosing between a kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "DTYPE_CODES", "build", "ptxas_report", "call", "launch",
           "on_card"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {name: _CSRC / f"{name}.cu"
           for name in ("flash_fwd", "flash_bwd", "layer_norm")}
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_libs: dict = {}
_lib_lock = threading.Lock()
# the kernels' dtype argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLASH_TAIL = [ctypes.POINTER(ctypes.c_int64), _F, _I, _P]
_SIGNATURES = {
    # pointers, then b, nq, nk, h, d, strides, scale, dtype, stream
    "flash_fwd": {"bifold_flash_fwd_infer": [_P] * 5 + [_I] * 5 + _FLASH_TAIL,
                  "bifold_flash_fwd_lse": [_P] * 6 + [_I] * 5 + _FLASH_TAIL},
    "flash_bwd": {"bifold_flash_bwd": [_P] * 10 + [_I] * 5 + _FLASH_TAIL},
    # pointers, then rows, cols, eps (forward) or blocks (backward), dtype,
    # param dtype, stream; the occupancy query: cols, dtype, fused, three
    # int pointers out, no stream
    "layer_norm": {"bifold_ln_fwd": [_P] * 6 + [_I, _I, _F, _I, _I, _P],
                   "bifold_fused_ln_fwd": [_P] * 8 + [_I, _I, _F, _I, _I, _P],
                   "bifold_ln_bwd": [_P] * 9 + [_I] * 5 + [_P],
                   "bifold_fused_ln_bwd": [_P] * 10 + [_I] * 5 + [_P],
                   "bifold_ln_bwd_occupancy": [_I] * 3 + [ctypes.POINTER(_I)] * 3},
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the port's "
            "kernels are built from bifold_tpu_torch/csrc/*.cu at first use")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return _BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str = "flash_fwd") -> Path:
    """Compile ``SOURCES[name]`` for sm_90a into ``_build/`` (skipped when a
    library built from the same bytes is there) and return its path; the
    ``-Xptxas -v`` report goes beside it (:func:`ptxas_report`)."""
    source = SOURCES[name]
    out = _library_path(name)
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source.name} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    tmp.replace(out)
    return out


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the build of ``SOURCES[name]`` (built
    first if needed)."""
    return build(name).with_suffix(".ptxas.txt").read_text()


def _library(name: str):
    """The loaded library of ``SOURCES[name]``, built at its first use."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bifold_cuda_error_string.argtypes = [ctypes.c_int]
            lib.bifold_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def call(name, fn_name, device, *args):
    """Call ``fn_name`` of ``SOURCES[name]``'s library with ``args``, on
    ``device``; raise on an error."""
    lib = _library(name)
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           + lib.bifold_cuda_error_string(err).decode())


def launch(name, fn_name, device, *args):
    """:func:`call` with the current stream of ``device`` appended."""
    call(name, fn_name, device, *args, torch.cuda.current_stream(device).cuda_stream)


def on_card(fn_name, x) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{fn_name}: no kernel for device {x.device}")
    return True
