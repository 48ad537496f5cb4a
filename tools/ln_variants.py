#!/usr/bin/env python3
"""Times of the port's LayerNorm backward kernels, against another version
of the repo and as a per-block timeline, on one CUDA card:

    python3 tools/ln_variants.py [--against DIR] [--timeline]

It times ``ln_bwd`` and ``fused_ln_bwd`` at the train step's fusion and
vision rows (bf16, 8 input sets in turn, device time per call from CUDA
events around calls queued behind a sleep kernel,
``chip_smoke.queued_ms``), beside ``x + dy`` and ``addcmul(x, dy,
ds_out)``, one PyTorch kernel each that moves the bytes of ``ln_bwd`` and
``fused_ln_bwd``. ``--against DIR`` takes another checkout of the repo
(for example the parent commit unpacked by ``git archive`` into a
git-ignored directory) and times it and this one in turns, each in a
process of its own that imports its own ``bifold_tpu_torch`` and
``chip_smoke`` (DIR, this, this, DIR). ``--timeline`` builds this
checkout's ``csrc/layer_norm.cu`` with ``%globaltimer`` stamps in every
block (start, first row landed in warp 0, rows done, partial row written,
grid sync passed, column sums done) through ``flash_variants.build_variant``
and prints, for one call at each shape, each stamp's min / p50 / p90 / max
over the blocks, in us from the first block's start. One JSON line per
result, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("ln_bwd", "fused_ln_bwd")
_STAMPS = ("start", "row0_landed_warp0", "rows_done_warp0", "rows_done_block",
           "partial_written", "grid_sync_passed", "colsums_done")


def _stamp(k: int) -> str:
    return f"if (threadIdx.x == 0) g_stamps[blockIdx.x * 8 + {k}] = gtime();"


# (text in csrc/layer_norm.cu, replacement)
TIMELINE = [
    ("// One cooperative launch per call: rows, then each block's partial sums of",
     "__device__ unsigned long long g_stamps[65536 * 8];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n\n"
     "// One cooperative launch per call: rows, then each block's partial sums of"),
    ("  constexpr int kRowT = kFused ? 3 : 2;  // x (or s), dy, and ds_out",
     "  constexpr int kRowT = kFused ? 3 : 2;  // x (or s), dy, and ds_out\n  " + _stamp(0)),
    ("      mbar_wait(&bars[slot], (i / kStages) & 1);",
     "      mbar_wait(&bars[slot], (i / kStages) & 1);\n      if (i == 0) " + _stamp(1)),
    ("  __syncthreads();\n  float* red = ",
     f"  {_stamp(2)}\n  __syncthreads();\n  {_stamp(3)}\n  float* red = "),
    ("  cg::this_grid().sync();\n",
     f"  {_stamp(4)}\n  cg::this_grid().sync();\n  {_stamp(5)}\n"),
    ("  }\n}\n\nbool misaligned(", f"  }}\n  {_stamp(6)}\n}}\n\nbool misaligned("),
    ("const char* bifold_cuda_error_string(int err) {",
     "int bifold_ln_stamps(unsigned long long* out, int n) {\n"
     "  return cudaMemcpyFromSymbol(out, g_stamps, n * sizeof(unsigned long long));\n}\n\n"
     "const char* bifold_cuda_error_string(int err) {"),
]


def _modules(root: Path):
    """(chip_smoke, ops.layer_norm) of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import chip_smoke
    from bifold_tpu_torch.ops import layer_norm
    return chip_smoke, layer_norm


def _calls(smoke, ln, gen):
    """{stack: {name: call}}: each call takes the next of 8 input sets of
    the stack's shape, with the forward kernel's stats."""
    out = {}
    for stack, (shape, eps) in smoke.LN_SHAPES.items():
        sets = []
        for _ in range(8):
            x, _, dy, ds_out, scale, bias = smoke.ln_inputs(gen, shape, torch.bfloat16)
            _, mean, rstd = ln.ln_forward(x, scale, bias, eps)
            sets.append((x, dy, ds_out, mean, rstd, scale))

        def in_turn(fn, sets=sets):
            turn = itertools.cycle(sets)
            return lambda: fn(*next(turn))

        out[stack] = {
            "ln_bwd": in_turn(lambda x, dy, ds, m, r, sc: ln.ln_backward(x, dy, m, r, sc)),
            "fused_ln_bwd": in_turn(
                lambda x, dy, ds, m, r, sc: ln.fused_ln_backward(x, dy, ds, m, r, sc)),
            "x + dy": in_turn(lambda x, dy, ds, m, r, sc: torch.add(x, dy)),
            "addcmul(x, dy, ds_out)": in_turn(
                lambda x, dy, ds, m, r, sc: torch.addcmul(x, dy, ds))}
    return out


def time_here(root: Path, names) -> None:
    """One JSON line {"stack", "name", "ms"} per stack and name of
    :func:`_calls`, for the checkout at ``root``."""
    smoke, ln = _modules(root)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for stack, calls in _calls(smoke, ln, gen).items():
        for name in names:
            print(json.dumps({"stack": stack, "name": name,
                              "ms": smoke.queued_ms(calls[name])}), flush=True)


def _child(root: Path) -> dict:
    """{(stack, kernel): ms} of the checkout at ``root``, timed in a
    process of its own."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                           str(root)], capture_output=True, text=True, cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{proc.stderr[-4000:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return {(d["stack"], d["name"]): d["ms"] for d in lines}


def against(other: Path) -> None:
    """The other checkout and this one in turns: other, this, this, other."""
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        runs[who].append(_child(other if who == "other" else ROOT))
    for key in runs["this"][0]:
        times = {who: [r[key] for r in rs] for who, rs in runs.items()}
        print(json.dumps({"stack": key[0], "kernel": key[1], "other": str(other),
                          "ms": {who: statistics.median(v) for who, v in times.items()},
                          "all_ms": times}), flush=True)


def timeline() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from flash_variants import build_variant

    smoke, ln = _modules(ROOT)
    from bifold_tpu_torch.ops import _cuda

    text = _cuda.SOURCES["layer_norm"].read_text()
    for old, new in TIMELINE:
        if text.count(old) != 1:
            raise AssertionError(f"{old!r} is not once in layer_norm.cu")
        text = text.replace(old, new)
    path = _cuda._BUILD_DIR / "variants" / "ln_timeline.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    libs, _ = build_variant(f"layer_norm={path}")
    lib = libs["layer_norm"]
    lib.bifold_ln_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bifold_ln_stamps.restype = ctypes.c_int
    base = _cuda._library("layer_norm")
    _cuda._libs["layer_norm"] = lib
    ln._RESIDENT.clear()                    # occupancy asked of the stamped build
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        for stack, calls in _calls(smoke, ln, gen).items():
            shape = smoke.LN_SHAPES[stack][0]
            rows = shape[0] * shape[1]
            for kernel in KERNELS:
                for _ in range(24):
                    calls[kernel]()
                torch.cuda.synchronize()
                calls[kernel]()                     # the call whose stamps are read
                torch.cuda.synchronize()
                blocks = ln.backward_grid(
                    *ln._resident(torch.device("cuda", torch.cuda.current_device()),
                                  kernel, 1, shape[-1]), rows)
                buf = (ctypes.c_ulonglong * (blocks * 8))()
                if lib.bifold_ln_stamps(ctypes.addressof(buf), blocks * 8) != 0:
                    raise RuntimeError("reading the stamps failed")
                stamps = [[buf[b * 8 + k] for k in range(len(_STAMPS))] for b in range(blocks)]
                t0 = min(s[0] for s in stamps)
                spread = {}
                for k, name in enumerate(_STAMPS):
                    v = sorted((s[k] - t0) / 1e3 for s in stamps)
                    spread[name] = [v[0], v[len(v) // 2], v[int(len(v) * 0.9)], v[-1]]
                print(json.dumps({"timeline_us_min_p50_p90_max": spread, "kernel": kernel,
                                  "stack": stack, "shape": list(shape), "blocks": blocks}),
                      flush=True)
    finally:
        _cuda._libs["layer_norm"] = base
        ln._RESIDENT.clear()


def main(other, with_timeline) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if other is not None:
        against(Path(other).resolve())
    else:
        time_here(ROOT, (*KERNELS, "x + dy", "addcmul(x, dy, ds_out)"))
    if with_timeline:
        timeline()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", metavar="DIR",
                        help="another checkout of the repo, timed in turns with this one")
    parser.add_argument("--timeline", action="store_true",
                        help="also the per-block timeline of one call at each shape")
    parser.add_argument("--child", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        time_here(Path(args.child), KERNELS)
        sys.exit(0)
    sys.exit(main(args.against, args.timeline))
