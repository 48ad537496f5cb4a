"""Experiment logging: console + JSONL metrics stream (+ wandb when present).

The port's copy of bifold_tpu/utils/logging.py (``Writer`` :29): per-step
loss, per-head terms, learning rate and step time, eval metric dicts, run
naming from the override string. The always-on sink is a ``metrics.jsonl``
in the run dir; wandb is attached only when enabled and importable.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

__all__ = ["Writer"]


def _jsonable(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class Writer:
    def __init__(self, run_dir: str | Path, *, use_wandb: bool = False,
                 project: str = "bifold-tpu", group: Optional[str] = None,
                 name: Optional[str] = None, config: Optional[Dict] = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.run_dir / "metrics.jsonl", "a", buffering=1)
        self._t0 = time.time()
        self.wandb = None
        if use_wandb:
            try:
                import wandb  # noqa: WPS433
                self.wandb = wandb
                wandb.init(project=project, group=group, name=name, config=config)
            except ImportError:
                print("[writer] wandb not installed; logging to metrics.jsonl only",
                      file=sys.stderr)

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()
        if self.wandb is not None:
            self.wandb.finish()
