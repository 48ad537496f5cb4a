"""Driver of a served cell: ``ServingModel.predict_batch(obs, pad_to=)``
called back to back by one caller (a closed loop), cycling a pool of
observations made at set-up.

Set-up loads the benchmark's seeded weights into the model, serves a copy
(big weights cast to the compute dtype, as the server does), wraps the
server's host stages ``_prepare`` and ``_upload`` in the benchmark's spans,
and calls two pool batches (the traffic has one shape). The window
calls for ``seconds`` (``--trace 1``: the cell's ``trace_steps`` calls under
the profiler), each call timed on the host clock to its one fetch; every
call's actions are kept. After the window the server is freed, and the
reference computes each pool observation's logits once and judges every
call's actions (``reference/serve.py``).

``fault="altered"`` (tests and ``tools/calibrate.py`` only) moves one
field of every call's first action by 48 pixels (three patches) where the
decode produces it; ``quantize="int8"`` serves the program's int8 path.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pb import spans, trace, traffic, weights, work
from pb import device as device_
from pb.cells import reference

REFERENCE_BLOCK = 8      # observations per reference forward


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        fault=None, quantize=None) -> dict:
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.ops import flash_attention as fa
    from bifold_tpu_torch.serving import ServingModel

    cfg, mix = cell["config_data"], cell["traffic_data"]
    dtype = getattr(torch, cfg["serve"]["compute_dtype"])
    ref = reference(cell["config"])
    w0 = weights.make(ref.param_shapes(cfg), cfg["init"], traffic.sub_seed(seed, "weights"),
                      device)
    w0 = {n: t.cpu() for n, t in w0.items()}       # the reference's copy, off the card
    pool = traffic.observations(mix, seed, device)
    device_.reset_peak(device)                     # the peak is the program's from here
    model = build_model(cfg["model"], dtype=dtype, device=device, seed=None)
    model.load_state_dict(w0, strict=True)
    proc = Processor(cfg["processor"], partition="test",
                     max_context_length=cfg.get("max_context_length"),
                     autoprocessor_name=cfg.get("autoprocessor_name"),
                     spm_asset=fixture_model_bytes() if cfg.get("autoprocessor_name") else None)
    server = ServingModel(model, None, proc, device=device, quantize=quantize)
    del model
    per_call = int(mix["pad_to"])
    calls = [pool[i: i + per_call] for i in range(0, len(pool), per_call)]
    if fault == "altered":
        inner = server._decode

        def decode(out, sample):
            packed = inner(out, sample).clone()
            packed[0, 0] = packed[0, 0] + 48.0
            return packed
        server._decode = decode
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    host = {}
    spans.wrap(server, "_prepare", host)
    spans.wrap(server, "_upload", host)
    for c in calls[:2]:                 # warm-up: the traffic's one shape, twice
        server.predict_batch(c, pad_to=per_call)
    device_.sync(device)
    record = {"kind": "serve", "config": cell["config"], "setup_s": time.perf_counter() - t0}
    for v in host.values():
        v.clear()
    served, call_ms = [], []

    def one(i):
        obs = calls[i % len(calls)]
        t = time.perf_counter()
        action = server.predict_batch(obs, pad_to=per_call)
        call_ms.append((time.perf_counter() - t) * 1e3)
        served.append((i % len(calls), np.stack([getattr(action, f) for f in _fields(action)], 1)))

    if traced:
        fa.SHAPES.clear()
        n = int(cell["trace_steps"])
        with trace.traced(device) as holder:
            for i in range(n):
                one(i)
        record.update(trace.reduce(holder.profile))
        record["flash_shapes"] = [[k, list(s), c] for (k, s), c in fa.SHAPES.items()]
        mask = cfg.get("key_mask")
        record["flash_kept_per_step"] = [
            sum(mask["base"] + mask["per_context_frame"] * min(len(o["context"]),
                                                               cfg["max_context_length"])
                for o in calls[i % len(calls)]) if mask else 0 for i in range(n)]
        record["key_mask_dim"] = (mask or {}).get("head_dim")
    else:
        t_start = time.perf_counter()
        i = 0
        while time.perf_counter() - t_start < seconds:
            one(i)
            i += 1
        record["window_s"] = time.perf_counter() - t_start
    record["call_ms"] = call_ms
    record["observations"] = len(call_ms) * per_call
    record["host_spans_ms"] = {k: list(v) for k, v in host.items()}
    ctx = [min(len(o["context"]), cfg.get("max_context_length") or 0)
           for idx, _ in served for o in calls[idx]]
    record["flops"] = sum(work.sample_flops(cfg["work"], c, train=False) for c in ctx)
    record["memory_peak_bytes"] = device_.peak(device)
    record["attempted"], record["failed"] = len(call_ms), 0

    del server
    device_.free(device)
    t_check = time.perf_counter()
    record["numbers"] = check_against_reference(ref, cfg, w0, calls, served, device)
    record["check_s"] = time.perf_counter() - t_check
    return record


def _fields(action):
    names = ("left_pick", "right_pick", "left_place", "right_place")
    return names if getattr(action, "left_pick", None) is not None else ("pick", "place")


def check_against_reference(ref, cfg, w0, calls, served, device) -> dict:
    from ref_common import Prec, float32_matmuls
    import ref_serve as serve

    float32_matmuls()
    W = {n: t.to(device) for n, t in w0.items()}
    heads = (("left_pick", "right_pick", "left_place", "right_place")
             if cfg["model"]["is_bimanual"] else ("pick", "place"))
    threshold = float(cfg["model"]["threshold"])
    bimanual = bool(cfg["model"]["is_bimanual"])
    per_batch = []
    for c in calls:
        logits, masks = serve.logits(ref, cfg, W, c, device, Prec("float32"), REFERENCE_BLOCK)
        per_batch.append((logits, [serve.nearest(m) for m in masks]))
    worst, judged = 0.0, {}
    for idx, packed in served:
        key = (idx, packed.tobytes())
        if key not in judged:
            logits, near = per_batch[idx]
            judged[key] = max(max(serve.action_gaps(heads, {h: logits[h][j] for h in heads},
                                                    near[j], packed[j], threshold, bimanual))
                              for j in range(packed.shape[0]))
        worst = max(worst, judged[key])
    return {"action_gap": worst}
