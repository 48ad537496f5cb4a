"""A heavy test fixture computed once per pytest run, not once per
pytest-xdist worker.

Under ``pytest -n N --dist load`` a module-scoped fixture runs on every
worker that picks up a test of its module. :func:`once_per_run` follows
pytest-xdist's documented pattern for sharing one result between workers: a
``filelock.FileLock`` in the directory that every worker's base temporary
directory shares (``tmp_path_factory.getbasetemp().parent``). The first
worker to take the lock computes the results into a directory there; the
others wait on the lock and then read them. A computation that raises
leaves no mark, so the next worker tries again. Without xdist it computes
into a fresh temporary directory."""

import os
import shutil
from pathlib import Path
from typing import Callable

from filelock import FileLock

__all__ = ["once_per_run"]


def once_per_run(tmp_path_factory, name: str, compute: Callable[[Path], None]) -> Path:
    """Run ``compute(directory)`` once per pytest run and return the
    directory it wrote its results into."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        out = tmp_path_factory.mktemp(name)
        compute(out)
        return out
    root = tmp_path_factory.getbasetemp().parent
    out, done = root / name, root / f"{name}.done"
    with FileLock(str(root / f"{name}.lock")):
        if not done.exists():
            shutil.rmtree(out, ignore_errors=True)
            out.mkdir()
            compute(out)
            done.touch()
    return out
