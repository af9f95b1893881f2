"""Request-lifecycle tracing, spans at the serving loop's existing sync
points (the port's copy of ``repro/serving/tracing.py``).

A request crosses six subsystems (router -> QoS -> deferred queue ->
paged/prefix-cache admission -> fused decode -> retire) and the metrics
registry only aggregates. This module records a per-request span
timeline — queue wait, prefill, decode — plus the events that explain them
(QoS grant/shed with class+client, deferred park/unpark, prefix-cache hit
tokens vs cold prefill, per-chunk emission, ``KV_POOL_EXHAUSTED`` stalls,
cancellation), and renders them three ways: timeline JSON for
``GET /v2/jobs/{id}/trace``, Chrome-trace-event JSON (Perfetto-loadable)
for ``GET /v2/trace/export``, and phase histograms in the shared
:class:`~repro_torch.serving.metrics.MetricsRegistry`.

Design constraints (mirroring ``metrics.py``):

- *zero new host syncs*: every stamp happens at a point the scheduler
  already touches host state — submit, admission, the tick's single host
  read, retire. Nothing here reads a device tensor.
- *lock-safe, bounded*: the recorder keeps a live map plus a fixed-size
  ring of finished traces (FIFO eviction); per-tick lane records and
  occupancy counter samples live in bounded deques. Nothing grows with
  uptime.
- *slow-request capture*: with ``slow_trace_ms`` set, once the finished
  ring is under pressure fast requests are compacted to their lifecycle
  summary (per-chunk detail dropped) while requests over the threshold —
  exactly the ones an operator pulls — retain full span detail.
- *one clock*: :func:`now` is THE serving clock. Deadlines, latency
  stamps, span boundaries, and histogram observations all read it, so
  every differenced pair of timestamps is meaningful (``time.monotonic``
  and ``time.perf_counter`` have unrelated epochs).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

__all__ = ("now", "RequestTrace", "Tracer")


def now() -> float:
    """The serving clock: monotonic seconds with an arbitrary epoch.

    Every timestamp the serving stack differentiates — request deadlines,
    TTFT/latency stamps, span boundaries, tick walls — must come from
    this one function so any two of them are mutually comparable.
    """
    return time.monotonic()


# events a compacted trace keeps: the lifecycle skeleton an operator needs
# even for fast requests (what was dropped is the per-chunk firehose)
_LIFECYCLE_EVENTS = frozenset({
    "submit", "qos_enqueue", "qos_grant", "qos_shed", "deferred_park",
    "deferred_unpark", "admit", "first_token", "stall", "cancel", "retire",
    # fault-tolerance lifecycle: quarantine/retry/recovery marks survive
    # compaction — they are exactly what an operator diffs after an
    # incident
    "fault", "retry", "retry_resubmit", "brownout",
})


class RequestTrace:
    """Span timeline of one request. Appended to by the submitting thread
    (before the scheduler sees the request) and by the single scheduler
    worker thread afterwards; list appends are atomic under the GIL and
    readers snapshot, so no per-trace lock is needed on the hot path."""

    __slots__ = (
        "trace_id", "model", "priority", "client", "prompt_tokens",
        "max_new_tokens", "submitted_at", "admitted_at", "first_token_at",
        "finished_at", "slot", "admitted_tick", "finished_tick",
        "completion_tokens", "outcome", "error_code", "admission",
        "events", "compacted",
    )

    def __init__(self, trace_id: int, *, model: str = "",
                 priority: str = "", client: str = "",
                 prompt_tokens: int = 0, max_new_tokens: int = 0,
                 submitted_at: Optional[float] = None):
        self.trace_id = trace_id
        self.model = model
        self.priority = priority
        self.client = client
        self.prompt_tokens = prompt_tokens
        self.max_new_tokens = max_new_tokens
        self.submitted_at = submitted_at if submitted_at is not None \
            else now()
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.slot = -1
        self.admitted_tick = -1
        self.finished_tick = -1
        self.completion_tokens = 0
        self.outcome: Optional[str] = None      # "ok" | error code
        self.error_code: Optional[str] = None
        # admission attributes (prefix-cache hit tokens, pages, COW) — the
        # warm-vs-cold distinction lives here
        self.admission: Optional[Dict[str, Any]] = None
        self.events: List[tuple] = [(self.submitted_at, "submit", None)]
        self.compacted = False

    # -- recording (existing sync points only) -----------------------------

    def event(self, name: str, ts: Optional[float] = None,
              **attrs) -> None:
        self.events.append((ts if ts is not None else now(),
                            name, attrs or None))

    def admitted(self, ts: float, *, slot: int, tick: int,
                 admission: Optional[Dict[str, Any]] = None) -> None:
        self.admitted_at = ts
        self.slot = slot
        self.admitted_tick = tick
        self.admission = dict(admission) if admission else None
        self.event("admit", ts, slot=slot, tick=tick,
                   **(self.admission or {}))

    def first_token(self, ts: float) -> None:
        if self.first_token_at is None:
            self.first_token_at = ts
            self.event("first_token", ts)

    # -- derived views ------------------------------------------------------

    def phases(self) -> Dict[str, Any]:
        """Phase durations in ms. By construction
        ``queue_ms + prefill_ms + decode_ms == e2e_ms`` exactly: each
        phase boundary is a single shared timestamp."""
        end = self.finished_at if self.finished_at is not None else now()
        adm, ft = self.admitted_at, self.first_token_at
        queue_end = adm if adm is not None else end
        prefill_end = ft if ft is not None else (end if adm is not None
                                                 else None)
        ms = lambda a, b: round(max(0.0, (b - a)) * 1e3, 3)  # noqa: E731
        return {
            "queue_ms": ms(self.submitted_at, queue_end),
            "prefill_ms": ms(adm, prefill_end) if adm is not None else 0.0,
            "decode_ms": ms(ft, end) if ft is not None else 0.0,
            "e2e_ms": ms(self.submitted_at, end),
            "sched_ticks": (self.finished_tick - self.admitted_tick + 1
                            if self.admitted_tick >= 0
                            and self.finished_tick >= 0 else 0),
        }

    def spans(self) -> List[Dict[str, Any]]:
        """Phase spans relative to submit, in ms."""
        out: List[Dict[str, Any]] = []
        rel = lambda t: round((t - self.submitted_at) * 1e3, 3)  # noqa: E731
        end = self.finished_at if self.finished_at is not None else now()
        adm, ft = self.admitted_at, self.first_token_at
        out.append({"name": "queue", "start_ms": 0.0,
                    "dur_ms": rel(adm if adm is not None else end)})
        if adm is not None:
            span = {"name": "prefill", "start_ms": rel(adm),
                    "dur_ms": round(((ft if ft is not None else end)
                                     - adm) * 1e3, 3)}
            if self.admission:
                span["attrs"] = dict(self.admission)
            out.append(span)
        if ft is not None:
            out.append({"name": "decode", "start_ms": rel(ft),
                        "dur_ms": round((end - ft) * 1e3, 3)})
        return out

    def to_json(self) -> Dict[str, Any]:
        rel = lambda t: round((t - self.submitted_at) * 1e3, 3)  # noqa: E731
        return {
            "trace_id": self.trace_id,
            "model": self.model,
            "priority": self.priority,
            "client": self.client,
            "prompt_tokens": self.prompt_tokens,
            "max_new_tokens": self.max_new_tokens,
            "completion_tokens": self.completion_tokens,
            "slot": self.slot,
            "outcome": self.outcome,
            "error_code": self.error_code,
            "admission": self.admission,
            "phases": self.phases(),
            "spans": self.spans(),
            "events": [
                {"ts_ms": rel(ts), "name": name,
                 **({"attrs": attrs} if attrs else {})}
                for ts, name, attrs in list(self.events)
            ],
            "compacted": self.compacted,
        }

    def compact(self) -> None:
        """Drop per-chunk detail, keep the lifecycle skeleton (slow-request
        capture evicts fast traces to this form under ring pressure)."""
        self.events = [e for e in self.events if e[1] in _LIFECYCLE_EVENTS]
        self.compacted = True


class Tracer:
    """Bounded, lock-safe recorder of request traces + scheduler lanes.

    ``capacity`` bounds the finished-trace ring (FIFO eviction);
    ``slow_trace_ms`` enables slow-request capture: once the ring is full,
    finished traces under the threshold are compacted to their lifecycle
    summary while slower ones keep full per-chunk detail. ``ticks`` bounds
    the scheduler-tick lane and the occupancy counter track.
    """

    def __init__(self, *, capacity: int = 256,
                 slow_trace_ms: Optional[float] = None,
                 ticks: int = 2048, model: str = "", replica: str = ""):
        self.capacity = max(1, int(capacity))
        self.slow_trace_ms = slow_trace_ms
        self.model = model
        # fleet deployments stamp each replica's tracer ("r0", "r1", …):
        # the Perfetto export gets one process group per replica and the
        # stats snapshot says which replica's ring it describes
        self.replica = replica
        self._lock = threading.Lock()
        self._live: Dict[int, RequestTrace] = {}
        self._done: "OrderedDict[int, RequestTrace]" = OrderedDict()
        self._ticks: deque = deque(maxlen=max(1, int(ticks)))
        self._counters: deque = deque(maxlen=max(1, int(ticks)))
        self._ids = itertools.count(1 << 30)   # sync-service trace ids —
        # offset far above scheduler request ids so the two never collide
        self.dropped = 0
        self.compacted = 0

    def next_id(self) -> int:
        """Trace id for callers without a scheduler request (SyncService)."""
        return next(self._ids)

    # -- request lifecycle ---------------------------------------------------

    def start(self, trace_id: int, **kw) -> RequestTrace:
        tr = RequestTrace(trace_id, model=kw.pop("model", self.model), **kw)
        with self._lock:
            self._live[trace_id] = tr
        return tr

    def finish(self, tr: RequestTrace, *, outcome: str,
               error_code: Optional[str] = None, tick: int = -1,
               completion_tokens: int = 0,
               ts: Optional[float] = None) -> None:
        tr.finished_at = ts if ts is not None else now()
        tr.finished_tick = tick
        tr.outcome = outcome
        tr.error_code = error_code
        tr.completion_tokens = completion_tokens
        tr.event("retire", tr.finished_at, outcome=outcome)
        with self._lock:
            self._live.pop(tr.trace_id, None)
            if len(self._done) >= self.capacity:
                # ring under pressure: slow-request capture keeps detail
                # only for requests over the threshold
                if self.slow_trace_ms is not None and not tr.compacted \
                        and tr.phases()["e2e_ms"] < self.slow_trace_ms:
                    tr.compact()
                    self.compacted += 1
                while len(self._done) >= self.capacity:
                    self._done.popitem(last=False)
                    self.dropped += 1
            self._done[tr.trace_id] = tr

    def get(self, trace_id: int) -> Optional[Dict[str, Any]]:
        """Timeline JSON for one request (live or finished), else None."""
        with self._lock:
            tr = self._live.get(trace_id) or self._done.get(trace_id)
        return tr.to_json() if tr is not None else None

    # -- scheduler lanes -----------------------------------------------------

    def tick(self, idx: int, t0: float, t1: float, *, k: int,
             active: int, emitted: int,
             kv_blocks_in_use: Optional[int] = None,
             prefix_cached_pages: Optional[int] = None) -> None:
        """One scheduler tick: recorded at the tick's existing sync point
        with host-side values only (occupancy counters come from the
        engine's host mirrors, never a device read)."""
        self._ticks.append((idx, t0, t1, k, active, emitted))
        if kv_blocks_in_use is not None or prefix_cached_pages is not None:
            self._counters.append((t1, kv_blocks_in_use,
                                   prefix_cached_pages))

    # -- export --------------------------------------------------------------

    def to_chrome(self, *, pid: int = 1,
                  process_name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Chrome-trace-event JSON (the Perfetto-loadable array format).

        Lanes (tids): 0 = scheduler ticks, 1 = queue, 1000+slot = decode
        slots. Timestamps are the serving clock in microseconds — all
        tracers share :func:`now`, so multi-deployment exports line up.
        """
        with self._lock:
            traces = list(self._done.values()) + list(self._live.values())
            ticks = list(self._ticks)
            counters = list(self._counters)
        us = lambda t: round(t * 1e6, 1)  # noqa: E731
        name = process_name or self.model or "serving"
        if process_name is None and self.replica:
            name = f"{name}/{self.replica}"
        ev: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": name}},
            {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
             "args": {"name": "scheduler ticks"}},
            {"ph": "M", "pid": pid, "tid": 1, "name": "thread_name",
             "args": {"name": "queue"}},
        ]
        seen_slots = set()
        t_end = now()
        for idx, t0, t1, k, active, emitted in ticks:
            ev.append({"ph": "X", "pid": pid, "tid": 0,
                       "name": f"tick {idx}", "cat": "scheduler",
                       "ts": us(t0), "dur": max(0.1, us(t1) - us(t0)),
                       "args": {"chunk_k": k, "active": active,
                                "emitted": emitted}})
        for ts, kv, pages in counters:
            if kv is not None:
                ev.append({"ph": "C", "pid": pid, "tid": 0,
                           "name": "kv_pool_blocks_in_use", "ts": us(ts),
                           "args": {"blocks": kv}})
            if pages is not None:
                ev.append({"ph": "C", "pid": pid, "tid": 0,
                           "name": "prefix_cache_pages", "ts": us(ts),
                           "args": {"pages": pages}})
        for tr in traces:
            end = tr.finished_at if tr.finished_at is not None else t_end
            label = f"req {tr.trace_id} [{tr.priority or '-'}]"
            slot_tid = 1000 + tr.slot if tr.slot >= 0 else 1
            if tr.slot >= 0 and tr.slot not in seen_slots:
                seen_slots.add(tr.slot)
                ev.append({"ph": "M", "pid": pid, "tid": slot_tid,
                           "name": "thread_name",
                           "args": {"name": f"slot {tr.slot}"}})
            args = {"trace_id": tr.trace_id, "client": tr.client,
                    "outcome": tr.outcome,
                    "prompt_tokens": tr.prompt_tokens,
                    "completion_tokens": tr.completion_tokens}
            queue_end = tr.admitted_at if tr.admitted_at is not None else end
            ev.append({"ph": "X", "pid": pid, "tid": 1,
                       "name": f"{label} queue", "cat": "queue",
                       "ts": us(tr.submitted_at),
                       "dur": max(0.1, us(queue_end) - us(tr.submitted_at)),
                       "args": args})
            if tr.admitted_at is not None:
                pf_end = tr.first_token_at \
                    if tr.first_token_at is not None else end
                ev.append({"ph": "X", "pid": pid, "tid": slot_tid,
                           "name": f"{label} prefill", "cat": "prefill",
                           "ts": us(tr.admitted_at),
                           "dur": max(0.1, us(pf_end) - us(tr.admitted_at)),
                           "args": {**args, **(tr.admission or {})}})
            if tr.first_token_at is not None:
                ev.append({"ph": "X", "pid": pid, "tid": slot_tid,
                           "name": f"{label} decode", "cat": "decode",
                           "ts": us(tr.first_token_at),
                           "dur": max(0.1, us(end) - us(tr.first_token_at)),
                           "args": args})
            for ts, nm, attrs in list(tr.events):
                if nm in ("submit", "admit", "first_token", "retire"):
                    continue           # already rendered as span boundaries
                ev.append({"ph": "i", "pid": pid,
                           "tid": slot_tid if tr.slot >= 0 else 1,
                           "name": f"{label} {nm}", "cat": "event",
                           "ts": us(ts), "s": "t",
                           "args": attrs or {}})
        return ev

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"enabled": True, "live": len(self._live),
                   "finished": len(self._done), "capacity": self.capacity,
                   "dropped": self.dropped, "compacted": self.compacted,
                   "slow_trace_ms": self.slow_trace_ms}
            if self.replica:
                out["replica"] = self.replica
            return out
