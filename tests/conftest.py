"""Repo-wide pytest wiring.

* Prepends ``src/`` (and ``tests/`` for helper modules) to ``sys.path`` so a
  bare ``python -m pytest`` works without the ``PYTHONPATH=src`` incantation.
* Registers the ``slow`` marker for the multi-minute subprocess tests; the
  quick loop is ``python -m pytest -m "not slow"``.
"""

from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (
    os.path.join(_ROOT, "src"),
    os.path.dirname(os.path.abspath(__file__)),
    _ROOT,  # `import benchmarks.*` under a bare `pytest` invocation
):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute subprocess tests; deselect with -m \"not slow\"",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips without one (python -m pytest -m gpu)",
    )
