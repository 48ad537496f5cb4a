#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced window. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``busy_s``, ``window_s`` and ``breakdown`` when traced)
and, last, ``checks``, each compared number beside its limit; the same
numbers are the last lines of standard error. A line before it gives the
card, its power limit, clocks and the seconds of set-up, of the program's
nvcc build within it (``build_s``), of the window and of the check. The
run exits with another code than 0 and prints no result when the cards are
missing, when the program cannot be imported, or when ``jax``, ``jaxlib``,
``flax`` or ``bifold_tpu`` is loaded in this process once the window has
closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)

FORBIDDEN = ("jax", "jaxlib", "flax", "bifold_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: int, device, t0: float, **faults):
    from pb import cells

    driver = cells.entry(cell["traffic_data"]["entry"])
    return driver.run(cell, seed, seconds, bool(trace), device, t0, **faults)


def _finite(x):
    return x if math.isfinite(x) else 1e300


def compared(cell: dict, record: dict) -> dict:
    """The numbers the cell's check compares: all but its ``read_only``."""
    return {k: v for k, v in record["numbers"].items() if k not in cell.get("read_only", ())}


def assemble(cell: dict, record: dict, trace: int, device_info: dict) -> dict:
    from pb import cells, check

    metrics = {}
    for module in cells.metrics(trace):
        value = module.read(record)
        if value is not None:
            metrics[module.NAME] = {"value": value, "unit": module.UNIT}
    correct, checks = check.verdict(compared(cell, record), cell["limits"])
    device = dict(device_info, memory_peak_bytes=int(record["memory_peak_bytes"]))
    out = {"correct": correct, "attempted": int(record["attempted"]),
           "failed": int(record["failed"]), "metrics": metrics, "device": device}
    if trace:
        device["busy_s"], device["window_s"] = record["busy_s"], record["window_s"]
        out["breakdown"] = record["breakdown"]
    out["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out


def smi() -> dict:
    """The card's name, power limit, SM clock and power draw now."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
            check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return dict(zip(("name", "power_limit", "sm_clock", "power_draw"),
                    (f.strip() for f in line.split(","))))


def build_kernels() -> float:
    """Builds the program's CUDA libraries, all at once, where the checkout
    has none yet (its first run), and returns the seconds that took: part
    of ``setup_s``, and printed apart on the run's information line."""
    from concurrent.futures import ThreadPoolExecutor

    from bifold_tpu_torch.ops import _cuda

    t = time.perf_counter()
    with ThreadPoolExecutor(len(_cuda.SOURCES)) as pool:
        list(pool.map(_cuda.build, _cuda.SOURCES))
    return time.perf_counter() - t


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from pb import cells

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build_s = build_kernels()
    before = smi()
    record = run_cell(cell, args.seed, args.seconds, args.trace, device, T0)
    after = smi()
    print(json.dumps({"card": before.get("name"), "power_limit": before.get("power_limit"),
                      "sm_clock": [before.get("sm_clock"), after.get("sm_clock")],
                      "power_draw": [before.get("power_draw"), after.get("power_draw")],
                      "torch": torch.__version__, "seed": args.seed,
                      "window_s": record.get("window_s"), "setup_s": record.get("setup_s"),
                      "build_s": build_s,
                      "check_s": record.get("check_s"), "run_s": time.perf_counter() - T0}),
          flush=True)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"])}
    record["card"] = info["kind"]
    result = assemble(cell, record, args.trace, info)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 3
    from pb import check

    for name in cell.get("read_only", ()):
        print(f"read, not compared: {name} {record['numbers'].get(name)!r}", file=sys.stderr)
    check.report(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
