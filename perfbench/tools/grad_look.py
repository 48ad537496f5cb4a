#!/usr/bin/env python3
"""The leaves behind a train cell's ``grad_gap``, seed by seed.

    python3 perfbench/tools/grad_look.py <cell> <dtype> <seed> [<seed> ...]

on a card, from the root of a checkout. Runs the cell's checked steps and
its reference (no window) with the program at ``dtype`` (``bfloat16``, as
the configuration states, or ``float32``, a second witness) and prints one
JSON line per seed: the numbers the check compares and, for the eight
leaves of the worst first-gradient norm gap, the program's and the
reference's norms, the median leaf's, the gap, the norm of the difference
over the reference's norm, and the cosine of the two gradients.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def look(prog: dict, ref: dict, top: int = 8) -> list:
    rg = {n: g.float().cpu() for n, g in ref["grads"].items()}
    pg = {n: g.float().cpu() for n, g in prog["grads"].items()}
    norms = {n: float(g.norm()) for n, g in rg.items()}
    floor = statistics.median(norms.values())
    rows = []
    for n, r in rg.items():
        p = pg[n]
        mine = float(p.norm())
        gap = abs(mine - norms[n]) / max(norms[n], floor, 1e-30)
        diff = float((p - r).norm()) / max(norms[n], 1e-30)
        cos = float((p * r).sum()) / max(mine * norms[n], 1e-30)
        rows.append([gap, n, mine, norms[n], floor, diff, cos])
    rows.sort(reverse=True)
    return rows[:top]


def main(argv) -> int:
    import torch

    import run
    from pb import cells, check

    name, dtype, seeds = argv[0], argv[1], [int(s) for s in argv[2:]]
    cell = cells.load_cell(name)
    cell["config_data"]["train"]["compute_dtype"] = dtype
    device = torch.device("cuda", 0)
    seen = {}
    plain = check.train_detail

    def detail(prog, ref):
        seen["look"] = look(prog, ref)
        return plain(prog, ref)
    check.train_detail = detail
    for seed in seeds:
        t = time.perf_counter()
        record = run.run_cell(cell, seed, 0.0, 0, device, t)
        print(json.dumps({"cell": name, "dtype": dtype, "seed": seed, **record["numbers"],
                          "losses": record["check_detail"]["losses"], "look": seen["look"],
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
