#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from, in one process.

    python3 perfbench/tools/calibrate.py <cell> <mode> <first seed> <count> [seconds]

on a card, from the root of a checkout. ``mode`` is ``program`` (the cell's
run with its window cut to ``seconds``, default 0 for a train cell: the
checked steps and the reference), ``control`` (the reference in float8
e4m3 products in the program's place, against the float32 reference, on
the run's own weights and inputs: a train cell's steps, a served cell's
actions decoded as the server decodes), ``int8`` (a served cell: the
program's own int8 server) or ``fault:<name>`` (the cell's run with the
fault ``<name>`` planted: ``unchanged``, ``half_batch``, ``altered``). One JSON line per
seed on standard output, also appended to
``chiprun_out/calibrate/<cell>.jsonl``. ``PERF.md`` gives the readings each
limit was set from.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def train_control(cell, seed, device) -> dict:
    """The float8 reference against the float32 one on the run's inputs."""
    from pb import cells, check, traffic, weights

    cfg = cell["config_data"]
    ref = cells.reference(cell["config"])       # puts the reference on the path
    from ref_common import Prec, float32_matmuls
    import ref_train_steps

    float32_matmuls()
    W = weights.make(ref.param_shapes(cfg), cfg["init"], traffic.sub_seed(seed, "weights"),
                     device)
    batches = traffic.train_batches(cell["traffic_data"], cfg, seed, device)
    steps = int(cell["check_steps"])
    dropout = traffic.sub_seed(seed, "dropout")
    low = ref_train_steps.run(ref, cfg, W, batches, steps, dropout, device, Prec("fp8"), 4)
    high = ref_train_steps.run(ref, cfg, W, batches, steps, dropout, device, Prec("float32"), 4)
    return check.train_numbers(low, high)


def serve_control(cell, seed, device) -> dict:
    """The reference in float8 products, decoded as the server decodes,
    judged against the float32 reference, on the run's pool."""
    from pb import cells, traffic, weights

    cfg = cell["config_data"]
    ref = cells.reference(cell["config"])       # puts the reference on the path
    from ref_common import Prec, float32_matmuls
    import ref_serve

    float32_matmuls()
    W = weights.make(ref.param_shapes(cfg), cfg["init"], traffic.sub_seed(seed, "weights"),
                     device)
    pool = traffic.observations(cell["traffic_data"], seed, device)
    heads = ref.HEADS
    bimanual = bool(cfg["model"]["is_bimanual"])
    threshold = float(cfg["model"]["threshold"])
    worst = 0.0
    for i in range(0, len(pool), 8):
        obs = pool[i:i + 8]
        high, masks = ref_serve.logits(ref, cfg, W, obs, device, Prec("float32"), 8)
        low, _ = ref_serve.logits(ref, cfg, W, obs, device, Prec("fp8"), 8)
        for j in range(len(obs)):
            near = ref_serve.nearest(masks[j])
            served = ref_serve.decode(heads, {h: low[h][j] for h in heads}, near, threshold,
                                      bimanual)
            worst = max([worst] + ref_serve.action_gaps(
                heads, {h: high[h][j] for h in heads}, near, served, threshold, bimanual))
    return {"action_gap": worst}


def main(argv) -> int:
    import torch

    import run
    from pb import cells

    name, mode, first, count = argv[0], argv[1], int(argv[2]), int(argv[3])
    cell = cells.load_cell(name)
    train = cell["traffic_data"]["entry"] == "train_step"
    seconds = float(argv[4]) if len(argv) > 4 else (0.0 if train else 3.0)
    device = torch.device("cuda", 0)
    out = Path("chiprun_out/calibrate")
    out.mkdir(parents=True, exist_ok=True)
    for seed in range(first, first + count):
        t = time.perf_counter()
        if mode == "control":
            numbers = (train_control if train else serve_control)(cell, seed, device)
        else:
            kw = {}
            if mode == "int8":
                kw["quantize"] = "int8"
            elif mode.startswith("fault:"):
                kw["fault"] = mode.split(":", 1)[1]
            elif mode != "program":
                raise SystemExit(f"unknown mode {mode!r}")
            record = run.run_cell(cell, seed, seconds, 0, device, t, **kw)
            numbers = dict(record["numbers"], detail=record.get("check_detail"))
        line = json.dumps({"cell": name, "mode": mode, "seed": seed, **numbers,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        with open(out / f"{name}.jsonl", "a") as f:
            f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
