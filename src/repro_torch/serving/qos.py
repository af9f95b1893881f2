"""QoS admission control for the serving path (the port's copy of
``repro/serving/qos.py``).

``BatchedService``'s original admission was a bare bounded FIFO deque with
``QUEUE_FULL`` as the only backpressure: under sustained overload one
greedy client fills the queue and starves everyone — the canonical
production-deployment failure mode for a model exchange that promises to
serve arbitrary developer traffic through one REST surface.

This module replaces the deque with an :class:`AdmissionController`:

- **priority classes** ``interactive > batch > best_effort`` scheduled by
  *smooth weighted round-robin* — higher classes get proportionally more
  dequeues (default 8:3:1) but no non-empty class is ever starved (the
  per-class no-starvation property test rides on this);
- **per-client fairness** inside each class via deficit round-robin over
  client identities (``X-MAX-Client`` header / job metadata, default
  ``anon``) — a greedy client queues behind its own backlog, not everyone
  else's;
- **per-client token-bucket rate limits** (requests/s with burst) that
  reject at submit time with ``RATE_LIMITED``;
- **deadline-aware load shedding**: work whose client-supplied deadline
  expired while queued is failed with ``DEADLINE_EXCEEDED`` at the next
  dequeue sweep instead of rotting in queue and occupying decode slots;
- **bounded per-class queues** so a flood in one class cannot block
  admission of another (``QUEUE_FULL`` stays per-class backpressure).

The controller never touches engine state; it only decides *order*. The
scheduler asks it for the next ``k`` admissions, the services translate
its structured :class:`AdmissionError` codes into error envelopes, and
every decision is recorded in a :class:`~repro_torch.serving.metrics.MetricsRegistry`.
"""

from __future__ import annotations

import itertools
import math
import threading
from collections import deque
from dataclasses import dataclass, field, replace as _dc_replace
from types import MappingProxyType
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.tracing import now as tracing_now

#: priority classes, highest first — order is the tiebreak in WRR
PRIORITIES: Tuple[str, ...] = ("interactive", "batch", "best_effort")

DEFAULT_CLASS_WEIGHTS: Mapping[str, int] = MappingProxyType({
    "interactive": 8, "batch": 3, "best_effort": 1,
})

DEFAULT_CLIENT = "anon"


class AdmissionError(Exception):
    """Structured admission failure; ``code`` maps to the HTTP surface.

    Deliberately NOT a :class:`~repro_torch.core.wrapper.MAXError` subclass —
    qos must stay importable without the core package (no cycle through
    ``core.service``); the service/API layers translate explicitly.

    ``retry_after_s`` is an optional client back-off hint; the HTTP layer
    surfaces it as a ``Retry-After`` header on 429/503 responses."""
    code = "INTERNAL"

    def __init__(self, *args, retry_after_s: Optional[float] = None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


class InvalidPriority(AdmissionError):
    """Unknown priority class on the request (HTTP 400)."""
    code = "INVALID_INPUT"


class RateLimited(AdmissionError):
    """Per-client token bucket empty — back off (HTTP 429)."""
    code = "RATE_LIMITED"


class QueueFull(AdmissionError):
    """The priority class's queue is at capacity (HTTP 429)."""
    code = "QUEUE_FULL"


class DeadlineExceeded(AdmissionError):
    """Client-supplied deadline passed before the work could run (504)."""
    code = "DEADLINE_EXCEEDED"


class Degraded(AdmissionError):
    """SOFT brownout: best_effort work is shed at admission (HTTP 503)."""
    code = "DEGRADED"


class CircuitOpen(AdmissionError):
    """HARD brownout: circuit breaker is open, nothing admits (HTTP 503)."""
    code = "CIRCUIT_OPEN"


@dataclass(frozen=True)
class QoSConfig:
    """Admission policy for one deployment. JSON-friendly via
    :meth:`from_json` so it can ride the v2 deploy body."""

    max_queue: int = 64                 # per priority class
    class_weights: Mapping[str, int] = field(
        default_factory=lambda: dict(DEFAULT_CLASS_WEIGHTS))
    rate: Optional[float] = None        # cost units/s per client; None = off
    burst: Optional[float] = None       # bucket size; default max(rate, 1)
    default_priority: str = "batch"
    quantum: float = 1.0                # DRR quantum (cost units per visit)
    policy: str = "drr"                 # "drr" | "fifo" (fifo = legacy order)
    # what one cost unit means: "request" charges a flat 1 per request,
    # "token" charges max_new_tokens — long generations drain the bucket
    # (and earn DRR deficit) proportionally to the decode work they buy,
    # so they are priced honestly instead of riding a flat tariff
    rate_unit: str = "request"          # "request" | "token"

    def __post_init__(self):
        if self.policy not in ("drr", "fifo"):
            raise ValueError(f"unknown qos policy {self.policy!r}")
        if self.rate_unit not in ("request", "token"):
            raise ValueError(f"unknown rate_unit {self.rate_unit!r} "
                             "(expected 'request' or 'token')")
        if self.default_priority not in self.class_weights:
            raise ValueError(
                f"default_priority {self.default_priority!r} not in "
                f"class_weights {sorted(self.class_weights)}")
        if any(w <= 0 for w in self.class_weights.values()):
            raise ValueError("class weights must be positive")
        if self.max_queue <= 0:
            raise ValueError("max_queue must be positive")
        if self.quantum <= 0:
            # a zero quantum would never earn any client enough deficit to
            # dequeue — the DRR loop would spin forever
            raise ValueError("quantum must be positive")
        if self.rate is not None and self.rate <= 0:
            raise ValueError("rate must be positive (or null to disable)")

    #: token budget charged for a generation request that omits
    #: max_new_tokens — matches the generation wrappers' default
    #: (core/assets.py), or a client could dodge token pricing by
    #: leaving the field out
    DEFAULT_TOKEN_BUDGET = 16

    def request_cost(self, max_new_tokens: Optional[int] = None) -> float:
        """Admission cost of one request under this config: a flat 1, or
        its token budget when ``rate_unit == "token"``. The single source
        of truth for both service kinds and the scheduler — they must not
        price the same request differently."""
        if self.rate_unit != "token":
            return 1.0
        n = self.DEFAULT_TOKEN_BUDGET if max_new_tokens is None \
            else max_new_tokens
        return float(max(1, int(n)))

    @property
    def classes(self) -> List[str]:
        """Classes in service-priority order (known first, then extras)."""
        known = [c for c in PRIORITIES if c in self.class_weights]
        extra = sorted(c for c in self.class_weights if c not in PRIORITIES)
        return known + extra

    def for_replica(self) -> "QoSConfig":
        """Per-replica copy with client rate limiting stripped: the fleet
        front door charges each client's token bucket once, globally;
        replicas keep the queue bounds and DRR ordering only. Without the
        strip, a dispatched request would be charged twice and every
        client's effective rate would halve."""
        if self.rate is None:
            return self
        return _dc_replace(self, rate=None, burst=None)

    @classmethod
    def from_json(cls, d: Optional[Mapping[str, Any]]) -> "QoSConfig":
        if d is None:
            return cls()
        if isinstance(d, QoSConfig):
            return d
        if not isinstance(d, Mapping):
            raise ValueError("qos config must be a JSON object")
        allowed = {"max_queue", "class_weights", "rate", "burst",
                   "default_priority", "quantum", "policy", "rate_unit"}
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(f"unknown qos config keys {sorted(unknown)} "
                             f"(expected subset of {sorted(allowed)})")
        return cls(**dict(d))


@dataclass
class Ticket:
    """One queued unit of work plus its admission metadata."""
    item: Any
    priority: str
    client: str
    cost: float
    seq: int
    enqueued_at: float                    # monotonic
    deadline: Optional[float] = None      # monotonic absolute, or None


class _TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = now

    def try_take(self, cost: float, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class AdmissionController:
    """Priority + fairness + rate-limit + deadline admission.

    Thread-safe: ``submit`` runs on request threads while ``take`` runs on
    the scheduler's worker thread. ``clock`` is injectable (monotonic
    seconds) so token-bucket refill and deadline shedding are deterministic
    under test.
    """

    def __init__(self, config: Optional[QoSConfig] = None, *,
                 metrics: Optional[MetricsRegistry] = None,
                 model_id: str = "", clock=tracing_now):
        self.cfg = config or QoSConfig()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.describe(
            "max_requests_total",
            "Finished/rejected requests by model, outcome and priority "
            "class (rejections counted at submit time)")
        self.metrics.describe(
            "max_queue_wait_seconds",
            "Admission-queue wait per admitted request, by priority class")
        self.metrics.describe(
            "max_shed_total",
            "Requests shed by deadline while queued, by priority class")
        self.model_id = model_id
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = itertools.count()
        # class -> client -> FIFO of tickets
        self._queues: Dict[str, Dict[str, deque]] = {
            c: {} for c in self.cfg.classes}
        self._rotation: Dict[str, deque] = {
            c: deque() for c in self.cfg.classes}   # DRR client order
        self._deficit: Dict[Tuple[str, str], float] = {}
        self._wrr_credit: Dict[str, float] = {c: 0.0 for c in self.cfg.classes}
        self._buckets: Dict[str, _TokenBucket] = {}
        self._depth_by_class: Dict[str, int] = {c: 0 for c in self.cfg.classes}
        self.shed_total = 0
        self.rate_limited_total = 0
        self.queue_full_total = 0

    # -- submit path (request threads) ------------------------------------

    def _labels(self, priority: str) -> Dict[str, str]:
        return {"model": self.model_id, "class": priority}

    def try_acquire(self, client: str, cost: float = 1.0,
                    priority: Optional[str] = None) -> None:
        """Token-bucket check only (no queuing) — the sync service's
        admission. Raises :class:`InvalidPriority` / :class:`RateLimited`."""
        priority = priority or self.cfg.default_priority
        if priority not in self._queues:
            raise InvalidPriority(
                f"unknown priority class {priority!r} "
                f"(expected one of {self.cfg.classes})")
        if self.cfg.rate is None:
            return
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get(client)
            if bucket is None:
                burst = self.cfg.burst if self.cfg.burst is not None \
                    else max(self.cfg.rate, 1.0)
                bucket = self._buckets[client] = _TokenBucket(
                    self.cfg.rate, burst, now)
            ok = bucket.try_take(cost, now)
        if not ok:
            with self._lock:
                self.rate_limited_total += 1
            self.metrics.inc("max_requests_total", 1,
                             outcome="rate_limited", **self._labels(priority))
            unit = "token" if self.cfg.rate_unit == "token" else "req"
            raise RateLimited(
                f"client {client!r} exceeded {self.cfg.rate:g} {unit}/s "
                f"(burst {bucket.burst:g}); retry later")

    def submit(self, item: Any, *, priority: Optional[str] = None,
               client: Optional[str] = None, cost: float = 1.0,
               deadline_s: Optional[float] = None) -> Ticket:
        """Admit ``item`` into the queue or raise an :class:`AdmissionError`.

        ``deadline_s`` is relative (seconds from now); expiry is enforced
        at dequeue sweeps, so a doomed item is failed, never executed.
        """
        priority = priority or self.cfg.default_priority
        client = client or DEFAULT_CLIENT
        if priority not in self._queues:
            raise InvalidPriority(
                f"unknown priority class {priority!r} "
                f"(expected one of {self.cfg.classes})")
        self.try_acquire(client, cost, priority)
        now = self._clock()
        ticket = Ticket(item=item, priority=priority, client=client,
                        cost=cost, seq=next(self._seq), enqueued_at=now,
                        deadline=None if deadline_s is None
                        else now + deadline_s)
        with self._lock:
            if self._depth_by_class[priority] >= self.cfg.max_queue:
                self.queue_full_total += 1
                full = True
            else:
                full = False
                q = self._queues[priority].get(client)
                if q is None:
                    q = self._queues[priority][client] = deque()
                if not q:
                    self._rotation[priority].append(client)
                q.append(ticket)
                self._depth_by_class[priority] += 1
        if full:
            self.metrics.inc("max_requests_total", 1, outcome="queue_full",
                             **self._labels(priority))
            raise QueueFull(
                f"{priority!r} queue full ({self.cfg.max_queue}); "
                "retry later")
        return ticket

    # -- dequeue path (scheduler worker) ----------------------------------

    def _sweep_expired(self, now: float) -> List[Ticket]:
        """Drop every expired or cancelled ticket (lock held). Cancellation
        is duck-typed off ``item.cancelled`` so this module stays importable
        without the scheduler — only the deadline-expired tickets count
        toward ``shed_total`` (the caller tells them apart the same way)."""

        def dead(t: Ticket) -> bool:
            return (getattr(t.item, "cancelled", False)
                    or (t.deadline is not None and t.deadline <= now))

        shed: List[Ticket] = []
        for cls, by_client in self._queues.items():
            for client in list(by_client):
                q = by_client[client]
                kept = deque(t for t in q if not dead(t))
                if len(kept) != len(q):
                    shed.extend(t for t in q if dead(t))
                    self._depth_by_class[cls] -= len(q) - len(kept)
                    by_client[client] = kept
                    if not kept:
                        del by_client[client]
                        try:
                            self._rotation[cls].remove(client)
                        except ValueError:
                            pass
                        self._deficit.pop((cls, client), None)
        self.shed_total += sum(
            1 for t in shed if not getattr(t.item, "cancelled", False))
        return shed

    def _pick_class(self) -> str:
        """Smooth weighted round-robin over non-empty classes: service
        proportional to weight, highest class on ties — never starves a
        non-empty class."""
        nonempty = [c for c in self.cfg.classes if self._depth_by_class[c]]
        if len(nonempty) == 1:
            return nonempty[0]
        if self.cfg.policy == "fifo":
            # legacy global arrival order: class of the oldest ticket
            return min(nonempty,
                       key=lambda c: min(q[0].seq
                                         for q in self._queues[c].values()))
        total = sum(self.cfg.class_weights[c] for c in nonempty)
        for c in nonempty:
            self._wrr_credit[c] += self.cfg.class_weights[c]
        order = {c: i for i, c in enumerate(self.cfg.classes)}
        best = max(nonempty,
                   key=lambda c: (self._wrr_credit[c], -order[c]))
        self._wrr_credit[best] -= total
        return best

    def _pop_from_class(self, cls: str) -> Ticket:
        """Deficit round-robin across this class's clients (lock held)."""
        rot, by_client = self._rotation[cls], self._queues[cls]
        if self.cfg.policy == "fifo":
            client = min(by_client, key=lambda c: by_client[c][0].seq)
        else:
            # arithmetic fast-forward: with token-unit costs a head request
            # may need thousands of quanta — credit the whole rounds every
            # client would accrue in one pass instead of spinning
            # O(cost/quantum) visits under the admission lock. Identical to
            # running the visit loop that many full rotations.
            rounds = min(
                max(1.0, math.ceil(
                    (by_client[c][0].cost
                     - self._deficit.get((cls, c), 0.0)) / self.cfg.quantum))
                for c in rot)
            if rounds > 1:
                for c in rot:
                    key = (cls, c)
                    self._deficit[key] = self._deficit.get(key, 0.0) \
                        + (rounds - 1) * self.cfg.quantum
            while True:                 # terminates within one rotation now
                client = rot[0]
                key = (cls, client)
                self._deficit[key] = self._deficit.get(key, 0.0) \
                    + self.cfg.quantum
                if self._deficit[key] >= by_client[client][0].cost:
                    break
                rot.rotate(-1)          # not enough credit: next client
        q = by_client[client]
        ticket = q.popleft()
        self._depth_by_class[cls] -= 1
        if self.cfg.policy != "fifo":
            self._deficit[(cls, client)] -= ticket.cost
        if not q:
            del by_client[client]
            try:
                rot.remove(client)
            except ValueError:
                pass
            self._deficit.pop((cls, client), None)
        elif self.cfg.policy != "fifo":
            rot.rotate(-1)              # one pop per visit: move on
        return ticket

    def take(self, k: int) -> Tuple[List[Ticket], List[Ticket]]:
        """Dequeue up to ``k`` tickets in QoS order.

        Returns ``(admitted, shed)`` — ``shed`` are deadline-expired
        tickets the caller must fail with ``DEADLINE_EXCEEDED``, plus
        cancelled ones (``item.cancelled``) it must retire as
        ``CANCELLED``. Expired/cancelled work is swept even when ``k == 0``
        so a full decode batch cannot make doomed work rot in queue.
        """
        now = self._clock()
        admitted: List[Ticket] = []
        with self._lock:
            shed = self._sweep_expired(now)
            while len(admitted) < k and self.depth_locked() > 0:
                admitted.append(self._pop_from_class(self._pick_class()))
        for t in admitted:
            self.metrics.observe("max_queue_wait_seconds",
                                 max(0.0, now - t.enqueued_at),
                                 **self._labels(t.priority))
        for t in shed:
            if not getattr(t.item, "cancelled", False):
                self.metrics.inc("max_shed_total", 1,
                                 **self._labels(t.priority))
        return admitted, shed

    # -- introspection -----------------------------------------------------

    def depth_locked(self) -> int:
        return sum(self._depth_by_class.values())

    def depth(self) -> int:
        with self._lock:
            return self.depth_locked()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            by_class = {c: n for c, n in self._depth_by_class.items()}
            by_client: Dict[str, int] = {}
            for by_c in self._queues.values():
                for client, q in by_c.items():
                    by_client[client] = by_client.get(client, 0) + len(q)
            return {
                "policy": self.cfg.policy,
                "queued": sum(by_class.values()),
                "queued_by_class": by_class,
                "queued_by_client": by_client,
                "shed": self.shed_total,
                "rate_limited": self.rate_limited_total,
                "queue_full": self.queue_full_total,
                "rate": self.cfg.rate,
                "rate_unit": self.cfg.rate_unit,
                "max_queue_per_class": self.cfg.max_queue,
            }
