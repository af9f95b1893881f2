"""The serving clock (local copy of ``repro/serving/tracing.py::now``).

Every differenced timestamp pair in the port's serving code routes
through :func:`now`. Request tracing itself is not ported yet."""

from __future__ import annotations

import time


def now() -> float:
    """Monotonic seconds — THE serving clock."""
    return time.perf_counter()
