"""The benchmark's tests: on the CPU at a tiny size, and one marked ``card``
that runs every cell on an NVIDIA card (it skips without one).

    python -m pytest perfbench/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for path in (str(ROOT.parent), str(ROOT), str(ROOT / "tools")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")
