"""The numbers that decide ``correct``, each against its limit.

Training (the first ``check_steps`` steps of the run, which the window's
own call and feed took on distinct batches, against the reference's steps
from the same weights, batches, augmentation draws and dropout seed):

- ``logit_gap``: the first step's forward, sample by sample: for each row
  of the batch and each head, the root mean square of the program's logits
  less the reference's over the field, over the root mean square of the
  reference field about its mean; the worst row and head. A row or head
  the program did not produce, or a gap that is not finite, reads infinite;
- ``loss_gap``: |program loss - reference loss| / |reference loss| of the
  first step (the later steps' losses swing from seed to seed, ``PERF.md``);
- ``grad_gap``: the first step's gradient as the optimizer took it (Adam's
  first moment after one step over 1 - beta1), the median over the leaves
  of |program norm - reference norm| / max(reference norm, the median
  leaf's); the median and not the worst leaf, because on a seed where a
  head's first gradient all but cancels (its norm near the median leaf's)
  the worst leaf reads the bfloat16 rounding of the logits and not a fault
  (``train_detail``'s ``grad_worst``, ``PERF.md``);
- ``step_gap``: the parameters' change over the steps, the median over the
  leaves of |program norm - reference norm| / max(reference norm, the
  median leaf's), over the leaves whose first reference gradient is at
  least a thousandth of the median leaf's (the others move by round-off);
  the median and not the worst leaf, because the worst leaf's gap comes
  from the later steps (``train_detail``'s look, ``PERF.md``).

Serving: ``action_gap``, the largest gap of a served action field over
every call of the window (``reference/serve.py:action_gaps``), in logits.

A number passes when it is at most its limit (``cell["limits"]``). A cell
may name numbers that it reads and prints but does not compare
(``cell["read_only"]``), where no limit between its sound runs and its
control would hold (``PERF.md``).
"""

from __future__ import annotations

import math
import statistics
import sys


def leaf_gaps(program: dict, reference: dict) -> dict:
    """Per leaf, |program norm - reference norm| over max(reference norm,
    the median leaf's) (``program``, ``reference``: leaf -> norm)."""
    floor = statistics.median(reference.values())
    return {n: abs(program.get(n, 0.0) - r) / max(r, floor, 1e-30)
            for n, r in reference.items()}


def row_gaps(prog: dict, ref: dict) -> list:
    """Per row and head of the first forward, the gap that ``logit_gap``
    takes the worst of (``prog``, ``ref``: head -> (B, S, S) logits)."""
    gaps = []
    for head, r in ref.items():
        r = r.float()
        p = prog.get(head)
        rows = 0 if p is None else p.shape[0]
        for i in range(r.shape[0]):
            if i >= rows or p.shape[1:] != r.shape[1:]:
                gaps.append(math.inf)
                continue
            spread = float((r[i] - r[i].mean()).pow(2).mean().sqrt())
            gap = float((p[i].float().to(r.device) - r[i]).pow(2).mean().sqrt())
            gaps.append(gap / max(spread, 1e-30) if math.isfinite(gap) else math.inf)
    if prog.keys() - ref.keys() or any(prog[h].shape[0] != ref[h].shape[0] for h in prog):
        gaps.append(math.inf)           # rows or heads the reference has not
    return gaps


def _moved(ref: dict) -> list:
    """The leaves whose first reference gradient is at least a thousandth
    of the median leaf's."""
    grads = {n: float(g.norm()) for n, g in ref["grads"].items()}
    floor = statistics.median(grads.values())
    return [n for n, g in grads.items() if g >= 1e-3 * floor]


def change_gaps(prog: dict, ref: dict, moved: list) -> dict:
    """Per moved leaf, |program change norm - reference change norm| over
    max(reference norm, the median leaf's) (``prog``, ``ref``: leaf -> norm)."""
    return leaf_gaps(prog, {n: ref[n] for n in moved})


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` per step, ``logits`` (the first
    forward's, by head), ``grads`` (the first step's gradient by leaf,
    tensors) and ``change_norms`` by leaf after the steps (and
    ``change_norms_1`` after the first, which ``train_detail`` reads)."""
    grads = {n: float(g.norm()) for n, g in ref["grads"].items()}
    mine = {n: float(g.norm()) for n, g in prog["grads"].items()}
    moved = _moved(ref)
    return {"logit_gap": max(row_gaps(prog["logits"], ref["logits"])),
            "loss_gap": abs(prog["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]),
                                                                      1e-30),
            "grad_gap": statistics.median(leaf_gaps(mine, grads).values() or [math.inf]),
            "step_gap": statistics.median(
                change_gaps(prog["change_norms"], ref["change_norms"], moved).values())}


def train_detail(prog: dict, ref: dict) -> dict:
    """What the numbers were taken from: both sides' losses over the steps;
    the median row's ``logit_gap``; the leaf of the worst first-gradient
    norm gap, that gap, both norms and the median leaf's norm; and the look
    behind ``step_gap``: the leaf of the worst change gap after the steps,
    that gap, its gap after the first step, and the worst leaf's gap after
    the first step."""
    grads = {n: float(g.norm()) for n, g in ref["grads"].items()}
    mine = {n: float(g.norm()) for n, g in prog["grads"].items()}
    gaps = leaf_gaps(mine, grads)
    name = max(gaps, key=gaps.get)
    moved = _moved(ref)
    change = change_gaps(prog["change_norms"], ref["change_norms"], moved)
    first = change_gaps(prog["change_norms_1"], ref["change_norms_1"], moved)
    worst = max(change, key=change.get)
    return {"losses": [prog["losses"], ref["losses"]],
            "logit_gap_median_row": statistics.median(row_gaps(prog["logits"],
                                                               ref["logits"])),
            "grad_worst": [name, gaps[name], mine.get(name), grads[name],
                           statistics.median(grads.values())],
            "change_worst": [worst, change[worst], first[worst], max(first.values())]}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its limit;
    a number without a limit, or not finite, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            ok = False
    return ok, out


def report(checks: dict) -> None:
    """The numbers beside their limits, as the last lines of stderr."""
    for name, v in checks.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr,
              flush=True)
