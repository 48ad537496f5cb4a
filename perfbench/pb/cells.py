"""Discovery by name: every cell, configuration, traffic mix, metric,
entry and reference is a file of its own under ``perfbench/``.

- a cell: ``workloads/<cell>.json`` (its configuration, traffic mix,
  chips, the steps of its traced window and the limits of its check);
- a configuration: ``configs/<config>.json``, with its plain reference
  ``reference/<config>.py`` beside it;
- a traffic mix: ``traffic/<mix>.json``, parameters that
  :mod:`pb.traffic` reads; its ``entry`` names the driver,
  ``pb/entries/<entry>.py``;
- a metric: ``metrics/<metric>.py`` with ``NAME``, ``UNIT``, ``TRACE`` (0:
  read from an untraced run, 1: from a traced one) and ``read(record)``,
  which returns a number or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"{name!r} ({path.relative_to(ROOT.parent)})")
    return json.loads(path.read_text())


def load_cell(name: str) -> dict:
    """The cell with its ``config`` and ``traffic`` resolved to their files'
    contents (``cell["config"]``, ``cell["traffic"]`` keep the names)."""
    cell = _json("workloads", name)
    cell["name"] = name
    cell["config_data"] = _json("configs", cell["config"])
    cell["traffic_data"] = _json("traffic", cell["traffic"])
    return cell


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reference(config: str):
    """The plain reference module of ``config``."""
    ref_dir = ROOT / "reference"
    if str(ref_dir) not in sys.path:
        sys.path.insert(0, str(ref_dir))
    return _load_module(ref_dir / f"{config}.py", f"pb_reference_{config}")


def entry(name: str):
    return _load_module(ROOT / "pb" / "entries" / f"{name}.py", f"pb_entry_{name}")


def metrics(trace: int) -> list:
    """Every metric module whose ``TRACE`` is ``trace``, by name."""
    out = []
    for path in sorted((ROOT / "metrics").glob("*.py")):
        module = _load_module(path, "pb_metric_" + path.stem.replace(".", "_"))
        if int(module.TRACE) == int(trace):
            out.append(module)
    return out
