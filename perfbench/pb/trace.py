"""The traced window: ``torch.profiler`` over a span of the benchmark's own,
reduced to device intervals, busy seconds and the breakdown.

:func:`traced` runs the window's body inside ``record_function("pb.window")``
with the device synchronised at both edges; :func:`reduce` takes every
device activity (kernels, copies, sets) inside that span, merges their
intervals (streams overlap, so their sum is not the busy time), and returns
the busy seconds, the window's seconds, the device time by kernel name and
the idle gaps between the merged intervals, each named by what the host was
doing at its middle: the innermost benchmark span (``pb.*``) and the
innermost host operation there.
"""

from __future__ import annotations

import contextlib

import torch

WINDOW = "pb.window"


@contextlib.contextmanager
def traced(device):
    """Profile the block; yields a holder whose ``profile`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Traced", (), {})()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield holder
            _sync(device)
    holder.profile = prof


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _events(prof):
    """(device events, host events) as (name, start_us, end_us)."""
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        item = (ev.name, float(tr.start), float(tr.end))
        if str(ev.device_type).endswith("CUDA"):
            # a span's copy on the device timeline is no device work
            if not (getattr(ev, "is_user_annotation", False) or ev.name.startswith("pb.")):
                dev.append(item)
        else:
            host.append(item)
    return dev, host


def merge(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, top: int = 10) -> dict:
    dev, host = _events(prof)
    spans = [h for h in host if h[0] == WINDOW]
    if not spans:
        raise RuntimeError("the traced window's span is missing from the trace")
    w0, w1 = spans[0][1], spans[0][2]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    merged = merge([(s, e) for _, s, e in inside])
    busy_us = sum(e - s for s, e in merged)
    by_name = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        around = [h for h in host if h[1] <= mid <= h[2] and h[0] != WINDOW]
        ours = [h for h in around if h[0].startswith("pb.")]
        label = min(ours, key=lambda h: h[2] - h[1])[0] if ours else "pb.window"
        op = min(around, key=lambda h: h[2] - h[1])[0] if around else "idle host"
        named.append([f"{label} / {op}"[:200], (e - s) * 1e-6])
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "kernel_s": {n: t * 1e-6 for n, t in by_name.items()},
            "breakdown": {"device_ops": [[n[:200], t * 1e-6] for n, t in device_ops],
                          "idle_gaps": named}}
