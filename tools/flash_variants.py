#!/usr/bin/env python3
"""Variants of the port's flash kernels against the sources as they are,
on one CUDA card:

    python3 tools/flash_variants.py [name ...] [--file SOURCE=PATH ...]
                                    [--dtype bfloat16|float32]

A named variant is a textual change to ``bifold_tpu_torch/csrc/flash_fwd.cu``
or ``flash_bwd.cu`` (:data:`VARIANTS`: the block size, a register cap
through the minimum blocks per SM of ``__launch_bounds__``); ``--file
flash_bwd=old/flash_bwd.cu`` takes a whole other version of a source. Each
must leave every row's arithmetic as it is. The script builds each variant
with ``nvcc -Xptxas -v`` into the git-ignored
``bifold_tpu_torch/_build/variants/``, prints its registers, shared memory
and spills, checks that its outputs are bitwise equal to the sources' own,
and times the inference and lse forwards at the serving and training shapes
and the backward at the training shapes (``--dtype``: the bf16 instances,
or the f32 ones at the f32 flagship's and the transformer decoder's
shapes; device time per call from CUDA events around calls queued behind
a sleep kernel, ``chip_smoke.queued_ms``), the two builds in turns (base,
variant, variant, base). One JSON line per variant and shape, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from bifold_tpu_torch.ops import _cuda  # noqa: E402
from bifold_tpu_torch.ops import flash_attention as fa  # noqa: E402

CAP = "__launch_bounds__(kMmaThreads, kBlocksPerSM)"
# name: [(source, text, replacement), ...]
VARIANTS = {
    # 128 query rows (8 warps) per forward block, 2 blocks per SM
    "fwd_rows128": [("flash_fwd", "constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                    ("flash_fwd", "constexpr int kBlocksPerSM = 4;",
                     "constexpr int kBlocksPerSM = 2;")],
    # no minimum of blocks per SM: the compiler's own register count
    "uncapped": [("flash_fwd", CAP, "__launch_bounds__(kMmaThreads)"),
                 ("flash_bwd", CAP, "__launch_bounds__(kMmaThreads)")],
    # the d32 dk/dv kernel: 32-row query stages (as d64 has), its column
    # loop fully unrolled (as before PR 8's choice of two), or three blocks
    # per SM
    "bwd_d32_tile32": [("flash_bwd", "constexpr int kTile = D > 48 ? 32 : 64;",
                        "constexpr int kTile = D == 48 ? 64 : 32;")],
    "bwd_d32_unroll4": [("flash_bwd", "#pragma unroll(D == 32 ? 2 : kTile / 16)",
                         "#pragma unroll")],
    "bwd_d32_cap3": [("flash_bwd", CAP + " dkdv_mma(",
                      "__launch_bounds__(kMmaThreads, D == 32 ? 3 : kBlocksPerSM) dkdv_mma(")],
    # the f32 (3xTF32) kernels: two or four blocks per SM in place of three
    # (a register cap of 255 or 128 in place of 168), forward and backward;
    # the backward's streamed stages at 16 or 64 rows in place of 32
    "f32_blocks2": [(src, "constexpr int kBlocksPerSMF32 = 3;",
                     "constexpr int kBlocksPerSMF32 = 2;") for src in ("flash_fwd", "flash_bwd")],
    "f32_blocks4": [(src, "constexpr int kBlocksPerSMF32 = 3;",
                     "constexpr int kBlocksPerSMF32 = 4;") for src in ("flash_fwd", "flash_bwd")],
    "f32_bwd_tile16": [("flash_bwd", "constexpr int kTileF32 = 32;",
                        "constexpr int kTileF32 = 16;")],
    "f32_bwd_tile64": [("flash_bwd", "constexpr int kTileF32 = 32;",
                        "constexpr int kTileF32 = 64;")],
}
# (b, n, h, d, fused qkv views); the flagship's fusion (d48) has its mask
FWD_SHAPES = {"serve_d48": (1, 2373, 16, 48, True), "serve_d64": (4, 576, 12, 64, False),
              "train_d48": (2, 2373, 16, 48, True), "train_d64": (8, 576, 12, 64, False),
              "serve_d32": (1, 275, 16, 32, True), "train_d32": (2, 275, 16, 32, True)}
# f32: the f32 flagship's stacks and the transformer decoder (577 tokens,
# 16 heads of 32, three Linear outputs: no fused views, no mask)
FWD_SHAPES_F32 = {**{k: v for k, v in FWD_SHAPES.items() if not k.endswith("d32")},
                  "serve_d32": (1, 577, 16, 32, False), "train_d32": (2, 577, 16, 32, False)}
BWD_SHAPES = ("train_d48", "train_d64", "train_d32")


class _Report:
    """The ``-Xptxas -v`` reports of a variant's sources, in the shape
    ``chip_smoke.ptxas_rows`` reads (``SOURCES``, ``ptxas_report``)."""

    def __init__(self, texts):
        self.texts = texts
        self.SOURCES = tuple(texts)

    def ptxas_report(self, source):
        return self.texts.get(source, "")


def _load(path: Path, source: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in _cuda._SIGNATURES[source].items():
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
    lib.bifold_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bifold_cuda_error_string.restype = ctypes.c_char_p
    return lib


def variant_texts(name: str) -> dict:
    """{source: text} of a named variant or of a ``SOURCE=PATH`` file."""
    if "=" in name:
        source, path = name.split("=", 1)
        return {source: Path(path).read_text()}
    texts = {}
    for source, old, new in VARIANTS[name]:
        text = texts.get(source, _cuda.SOURCES[source].read_text())
        if old not in text:
            raise AssertionError(f"{name}: {old!r} not in {source}.cu")
        texts[source] = text.replace(old, new)
    return texts


def build_variant(name: str):
    """{source: loaded library} of the variant and its ptxas report."""
    texts = variant_texts(name)
    out_dir = _cuda._BUILD_DIR / "variants" / name.replace("/", "_").replace("=", "_")
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _cuda._CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())

    def compile_one(source):
        (out_dir / f"{source}.cu").write_text(texts[source])
        lib = out_dir / f"lib{source}.so"
        proc = subprocess.run(
            [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
             str(out_dir / f"{source}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr)
        return source, _load(lib, source), proc.stderr

    with ThreadPoolExecutor() as pool:
        built = list(pool.map(compile_one, texts))
    return ({s: lib for s, lib, _ in built},
            chip_smoke.ptxas_rows(_Report({s: r for s, _, r in built})))


def _calls(gen, dtype):
    """{(kind, shape): (call, sources it launches)} at the main paths'
    shapes in ``dtype``."""
    calls = {}
    shapes = FWD_SHAPES if dtype == torch.bfloat16 else FWD_SHAPES_F32
    for shape, (b, n, h, d, fused) in shapes.items():
        q, k, v = chip_smoke.attention_inputs(gen, b, n, h, d, dtype, fused)
        mask = chip_smoke.fusion_mask(b, n, 0) if d == 48 else None
        fn = fa.flash_attention_fwd if shape.startswith("train") else fa.flash_attention
        calls[("fwd", shape)] = ((lambda fn=fn, a=(q, k, v, mask): fn(*a)), "flash_fwd")
        if shape in BWD_SHAPES:
            do = torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, mask)
            calls[("bwd", shape)] = (
                (lambda a=(q, k, v, mask, out, lse, do): fa.flash_attention_bwd(*a)),
                "flash_bwd")
    return calls


def main(names, dtype=torch.bfloat16) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    base = {s: _cuda._library(s) for s in ("flash_fwd", "flash_bwd")}
    variants = {}
    for name in names:
        variants[name], ptxas = build_variant(name)
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    calls = _calls(torch.Generator(device="cuda").manual_seed(0), dtype)
    for (kind, shape), (call, source) in calls.items():
        ref = call()
        for name, libs in variants.items():
            if source not in libs:
                continue
            times = {"base": [], name: []}
            for who in ("base", name, name, "base"):
                _cuda._libs[source] = base[source] if who == "base" else libs[source]
                got = call()
                same = all(torch.equal(x, y) for x, y in
                           zip(got if isinstance(got, tuple) else (got,),
                               ref if isinstance(ref, tuple) else (ref,)))
                if not same:
                    raise AssertionError(f"{name} differs from the sources at {shape}")
                times[who].append(chip_smoke.queued_ms(call))
            _cuda._libs[source] = base[source]
            print(json.dumps({"variant": name, "kernel": kind, "shape": shape,
                              "dtype": str(dtype),
                              "ms": {k: statistics.median(v) for k, v in times.items()},
                              "all_ms": times, "bitwise_equal": True}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*", help=f"named variants, of {list(VARIANTS)} "
                        "(default: all, unless --file)")
    parser.add_argument("--file", action="append", default=[], metavar="SOURCE=PATH",
                        help="a whole other version of csrc/SOURCE.cu")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="the instances to time (default bfloat16)")
    args = parser.parse_args()
    sys.exit(main([*(args.names or ([] if args.file else VARIANTS)), *args.file],
                  getattr(torch, args.dtype)))
