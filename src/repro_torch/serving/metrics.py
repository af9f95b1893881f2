"""Serving observability — a small lock-safe metrics registry (the port's
copy of ``repro/serving/metrics.py``).

A serving exchange is only trusted when its runtime behavior is observable
(ModelHub.AI-style hubs ship metrics with the models, not after them), so
the QoS subsystem records every admission decision here and the API layer
renders the registry at ``GET /v2/metrics`` — JSON by default, Prometheus
text exposition with ``?format=prometheus``.

Design constraints:

- *lock-safe*: counters/histograms are bumped from HTTP threads, the
  batched-service worker, and the admission controller concurrently;
- *bounded*: histograms keep fixed bucket counts plus a bounded ring of
  recent observations (for exact-ish p50/p95) — nothing grows with uptime;
- *dependency-free*: no prometheus_client in the container; the text
  format is ~30 lines to emit by hand.

Metric identity is ``name`` + sorted ``labels``; the registry interns one
object per identity so hot paths pay a dict lookup, not an allocation.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# default histogram bounds, in seconds — tuned for queue-wait / latency
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# sub-millisecond resolution for per-token pacing (inter-token gaps sit
# well under the latency buckets on a real accelerator)
TOKEN_LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                         0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    def esc(v: str) -> str:
        return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in key) + "}"


class Counter:
    """Monotonic float counter."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0):
        with self._lock:
            self.value += n


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (q in [0, 1])."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[idx]


class Histogram:
    """Fixed-bucket histogram + bounded reservoir of recent observations.

    Buckets give the Prometheus exposition (cumulative ``le`` counts); the
    reservoir (last ``reservoir`` observations) gives the p50/p95 the JSON
    rendering reports — exact over the recent window, O(1) memory.
    """

    __slots__ = ("buckets", "counts", "count", "sum", "_ring", "_lock")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 reservoir: int = 1024):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +inf tail
        self.count = 0
        self.sum = 0.0
        self._ring: deque = deque(maxlen=reservoir)
        self._lock = threading.Lock()

    def observe(self, v: float):
        with self._lock:
            self.count += 1
            self.sum += v
            self._ring.append(v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            recent = sorted(self._ring)
            return {
                "count": self.count,
                "sum": round(self.sum, 6),
                "p50": round(percentile(recent, 0.50), 6),
                "p95": round(percentile(recent, 0.95), 6),
            }

    def cumulative(self) -> List[Tuple[str, int]]:
        """Prometheus-style cumulative (le, count) pairs, +Inf last."""
        with self._lock:
            out, acc = [], 0
            for b, c in zip(self.buckets, self.counts):
                acc += c
                out.append((repr(b), acc))
            out.append(("+Inf", acc + self.counts[-1]))
            return out


class LabelledRegistry:
    """A view of a :class:`MetricsRegistry` that stamps fixed labels onto
    every series it records.

    The fleet layer hands each replica's service a
    ``LabelledRegistry(base, replica="rN")`` so the whole existing metric
    surface (QoS counters, phase histograms, KV gauges) gains a
    ``replica`` dimension without touching a single call site; explicit
    labels at the call site win over the stamped ones. Gauge teardown
    composes the same way: a replica's ``unregister_gauges(model=...)``
    carries its ``replica`` label, so closing one replica never drops a
    sibling's gauges."""

    def __init__(self, base: "MetricsRegistry", **labels):
        self._base = base
        self._labels = {k: str(v) for k, v in labels.items()}

    def _merge(self, labels: Dict[str, Any]) -> Dict[str, Any]:
        return {**self._labels, **labels}

    def describe(self, name: str, help_text: str):
        self._base.describe(name, help_text)

    def counter(self, name: str, **labels) -> "Counter":
        return self._base.counter(name, **self._merge(labels))

    def inc(self, name: str, n: float = 1.0, **labels):
        self._base.inc(name, n, **self._merge(labels))

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels) -> "Histogram":
        return self._base.histogram(name, buckets=buckets,
                                    **self._merge(labels))

    def observe(self, name: str, value: float, **labels):
        self._base.observe(name, value, **self._merge(labels))

    def register_gauge(self, name: str, fn: Callable[[], float], **labels):
        self._base.register_gauge(name, fn, **self._merge(labels))

    def unregister_gauges(self, **labels):
        self._base.unregister_gauges(**self._merge(labels))

    @property
    def created_at(self) -> float:
        return self._base.created_at

    def to_json(self) -> Dict[str, Any]:
        return self._base.to_json()

    def to_prometheus(self) -> str:
        return self._base.to_prometheus()


class MetricsRegistry:
    """Named, labelled counters/histograms with two renderings."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._hists: Dict[Tuple[str, LabelKey], Histogram] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Callable[[], float]] = {}
        self._help: Dict[str, str] = {}
        # maxlint: allow[clock-discipline] reason=registry uptime is an allowlisted wall-clock export, not a serving duration
        self.created_at = time.time()

    def describe(self, name: str, help_text: str):
        """Attach a ``# HELP`` description to a metric family (by base
        name, not per label set). Idempotent; call sites annotate the
        series they emit so the Prometheus exposition is self-documenting."""
        with self._lock:
            self._help[name] = " ".join(str(help_text).split())

    # -- recording ---------------------------------------------------------

    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
        return c

    def inc(self, name: str, n: float = 1.0, **labels):
        self.counter(name, **labels).inc(n)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        """``buckets`` only applies on first creation of the series
        (identity is name+labels; bounds cannot change under live data)."""
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(buckets or DEFAULT_BUCKETS)
        return h

    def observe(self, name: str, value: float, **labels):
        self.histogram(name, **labels).observe(value)

    def register_gauge(self, name: str, fn: Callable[[], float], **labels):
        """Render-time gauge: ``fn()`` is called at snapshot (queue depths
        and other instantaneous values must not need a write per change)."""
        with self._lock:
            self._gauges[(name, _label_key(labels))] = fn

    def unregister_gauges(self, **labels):
        """Drop gauges whose labels include ``labels`` (service teardown)."""
        want = set(_label_key(labels))
        with self._lock:
            for key in [k for k in self._gauges if want <= set(k[1])]:
                del self._gauges[key]

    # -- rendering ---------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
            gauges = dict(self._gauges)
        out: Dict[str, Any] = {
            # maxlint: allow[clock-discipline] reason=allowlisted wall-clock uptime export (diffed against the wall created_at)
            "uptime_s": round(time.time() - self.created_at, 3),
            "counters": {}, "gauges": {}, "histograms": {},
        }
        for (name, key), c in sorted(counters.items()):
            out["counters"][name + _label_str(key)] = c.value
        for (name, key), fn in sorted(gauges.items()):
            try:
                out["gauges"][name + _label_str(key)] = fn()
            except Exception:       # a dead gauge must not kill the page
                out["gauges"][name + _label_str(key)] = None
        for (name, key), h in sorted(hists.items()):
            out["histograms"][name + _label_str(key)] = h.snapshot()
        return out

    def to_prometheus(self) -> str:
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
            gauges = dict(self._gauges)
            help_ = dict(self._help)
        lines: List[str] = []
        seen_type = set()

        def typ(name: str, kind: str):
            if name not in seen_type:
                h = help_.get(name)
                if h:
                    esc = h.replace("\\", r"\\").replace("\n", r"\n")
                    lines.append(f"# HELP {name} {esc}")
                lines.append(f"# TYPE {name} {kind}")
                seen_type.add(name)

        # uptime is a first-class series in BOTH renderings (to_json
        # reports uptime_s): dashboards detect registry restarts from it
        lines.append("# HELP max_uptime_seconds "
                     "Seconds since this metrics registry was created")
        lines.append("# TYPE max_uptime_seconds gauge")
        seen_type.add("max_uptime_seconds")
        lines.append(   # maxlint: allow[clock-discipline] reason=allowlisted wall-clock uptime export (diffed against the wall created_at)
            f"max_uptime_seconds {round(time.time() - self.created_at, 3)}")
        for (name, key), c in sorted(counters.items()):
            typ(name, "counter")
            lines.append(f"{name}{_label_str(key)} {c.value}")
        for (name, key), fn in sorted(gauges.items()):
            try:
                v = fn()
            # maxlint: allow[exception-safety] reason=a failing gauge callback must not break the whole Prometheus scrape; the series is simply omitted
            except Exception:
                continue
            typ(name, "gauge")
            lines.append(f"{name}{_label_str(key)} {v}")
        for (name, key), h in sorted(hists.items()):
            typ(name, "histogram")
            snap = h.snapshot()
            for le, acc in h.cumulative():
                bkey = key + (("le", le),)
                lines.append(f"{name}_bucket{_label_str(bkey)} {acc}")
            lines.append(f"{name}_sum{_label_str(key)} {snap['sum']}")
            lines.append(f"{name}_count{_label_str(key)} {snap['count']}")
        return "\n".join(lines) + "\n"
