#!/usr/bin/env python3
"""Two sets of runs of one cell with the same seeds, and their spreads.

    python3 perfbench/tools/spread.py <cell> <seconds> <first seed> <runs per set> [traced runs]

on a card, from the root of a checkout: ``run.py --trace 0`` for seeds
``first .. first + runs - 1``, twice (set A, then set B), then ``traced``
runs with ``--trace 1`` on further seeds. Each run is a process of its own,
as the check runs it. Prints every result line, then per set and metric the
median and the spread, the distance between the first and third quartiles
(``statistics.quantiles(n=4)``) over the median; the bound of an
end-to-end metric is set from the wider of the two sets' spreads. All
lines also go to ``chiprun_out/spread/<cell>.jsonl``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one(cell, seed, seconds, trace, log) -> dict:
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                         capture_output=True, text=True)
    lines = out.stdout.strip().splitlines()
    rec = {"cell": cell, "seed": seed, "trace": trace, "rc": out.returncode,
           "wall_s": time.perf_counter() - t}
    if out.returncode == 0 and len(lines) >= 2:
        rec["info"] = json.loads(lines[-2])
        rec["result"] = json.loads(lines[-1])
    else:
        rec["stderr"] = out.stderr[-3000:]
    print(json.dumps(rec), flush=True)
    log.write(json.dumps(rec) + "\n")
    log.flush()
    return rec


def main(argv) -> int:
    cell, seconds, first, runs = argv[0], float(argv[1]), int(argv[2]), int(argv[3])
    traced = int(argv[4]) if len(argv) > 4 else 0
    out = Path("chiprun_out/spread")
    out.mkdir(parents=True, exist_ok=True)
    sets = {}
    with open(out / f"{cell}.jsonl", "a") as log:
        for name in ("A", "B"):
            sets[name] = [one(cell, first + i, seconds, 0, log) for i in range(runs)]
        for i in range(traced):
            one(cell, first + runs + i, seconds, 1, log)
    for name, recs in sets.items():
        ok = [r["result"] for r in recs if "result" in r]
        correct = sum(r["correct"] for r in ok)
        print(f"set {name}: {len(ok)} results, {correct} correct", flush=True)
        for metric in sorted({m for r in ok for m in r["metrics"]}):
            vals = [r["metrics"][metric]["value"] for r in ok if metric in r["metrics"]]
            if len(vals) >= 2:
                print(f"  {metric}: median {statistics.median(vals)!r} spread {spread(vals)!r} "
                      f"values {vals!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
