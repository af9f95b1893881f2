"""Fault-tolerance plane: deterministic fault injection + brownout control
(the port's copy of ``repro/serving/faults.py``; pure Python, no device
work: the same spec and seed fire the same faults at the same ticks).

A serving stack is only dependable if its failure behavior is *designed*,
and failure behavior can only be designed against faults that can be
reproduced. This module provides both halves:

**Fault injection** (:class:`FaultSpec` / :class:`FaultPlane`): a seeded or
scripted schedule of engine faults, checked by the scheduler at the exact
boundaries real faults occur —

- ``admission``  raise during prefill admission (before the engine touches
                 the slot, like an OOM or a bad compiled program at insert)
- ``chunk``      raise in place of a fused decode-chunk dispatch, before
                 anything is committed or revealed to token sinks
- ``stall``      sleep through a tick (a hung device / allocator stall the
                 watchdog must notice)
- ``kill``       raise :class:`WorkerKill` — a ``BaseException`` that
                 escapes the worker's fault isolation and kills the thread
                 (the in-process analogue of a worker process dying)

The plane is deterministic: the same spec and seed fire the same faults at
the same ticks for the same workload, so chaos scenarios are reproducible
in tests and benchmarks. With no plane attached (``faults=None``) the
scheduler's hook is a single ``is not None`` check — behavior is
byte-identical to a build without injection, and the zero-new-host-sync
and fused==stepwise properties hold untouched.

**Brownout degradation** (:class:`BrownoutConfig` /
:class:`BrownoutController`): sustained pressure signals (queue depth,
KV-pool exhaustion rate, tick stalls, engine faults) drive a
NORMAL -> SOFT -> HARD state machine with hysteresis. SOFT sheds
``best_effort`` work at admission (structured ``DEGRADED`` 503) and clamps
``max_new_tokens``; HARD breaks the circuit — every request is rejected
with ``CIRCUIT_OPEN`` (503 + ``Retry-After``) until pressure clears. The
states are the designed middle ground between "fully up" and "down":
a browned-out exchange keeps serving its interactive core instead of
collapsing under the whole offered load.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serving.qos import CircuitOpen, Degraded
from repro_torch.serving.tracing import now as _now

#: injection sites the scheduler checks
FAULT_SITES = ("admission", "chunk", "stall", "kill")

#: degradation states, in escalation order
BROWNOUT_STATES = ("normal", "soft", "hard")


class InjectedFault(Exception):
    """A deliberately injected engine fault (chaos testing). Carries the
    site and, for chunk faults, the single implicated slot — supervision
    quarantines exactly that slot instead of the whole co-batch."""

    def __init__(self, site: str, *, tick: int, slot: Optional[int] = None):
        msg = f"injected {site} fault at tick {tick}"
        if slot is not None:
            msg += f" (slot {slot})"
        super().__init__(msg)
        self.site = site
        self.tick = tick
        self.slot = slot


class WorkerKill(BaseException):
    """Injected worker death. A ``BaseException`` on purpose: it must
    escape the service worker's ``except Exception`` fault isolation and
    kill the thread, so the watchdog's dead-worker path is exercised for
    real — not a simulation of it."""


@dataclass(frozen=True)
class FaultSpec:
    """Validated fault schedule. ``*_rate`` are per-check probabilities
    drawn from one seeded stream (deterministic for a given workload);
    ``script`` entries ``{"tick": int, "site": str, "slot": int?}`` fire
    exactly once when the scheduler's check reaches that tick — the tool
    for tests that need a fault at a precise boundary."""

    seed: int = 0
    admission_rate: float = 0.0
    chunk_rate: float = 0.0
    stall_rate: float = 0.0
    stall_s: float = 0.02
    kill_rate: float = 0.0
    script: Tuple[Dict[str, Any], ...] = ()
    max_faults: Optional[int] = None

    _ALLOWED = ("seed", "admission_rate", "chunk_rate", "stall_rate",
                "stall_s", "kill_rate", "script", "max_faults")

    @classmethod
    def from_json(cls, obj: Optional[Dict[str, Any]]) -> "FaultSpec":
        if obj is None:
            return cls()
        if isinstance(obj, FaultSpec):
            return obj
        if not isinstance(obj, dict):
            raise ValueError("'faults' must be an object")
        unknown = set(obj) - set(cls._ALLOWED)
        if unknown:
            raise ValueError(f"unknown fault spec keys: {sorted(unknown)} "
                             f"(allowed: {list(cls._ALLOWED)})")
        out: Dict[str, Any] = {}
        for key in ("admission_rate", "chunk_rate", "stall_rate",
                    "kill_rate"):
            if key in obj:
                v = obj[key]
                if isinstance(v, bool) or not isinstance(v, (int, float)) \
                        or not 0.0 <= float(v) <= 1.0:
                    raise ValueError(f"{key!r} must be a number in [0, 1]")
                out[key] = float(v)
        if "stall_s" in obj:
            v = obj["stall_s"]
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v <= 0:
                raise ValueError("'stall_s' must be a positive number")
            out["stall_s"] = float(v)
        if "seed" in obj:
            v = obj["seed"]
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError("'seed' must be an integer")
            out["seed"] = v
        if "max_faults" in obj:
            v = obj["max_faults"]
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                raise ValueError("'max_faults' must be a non-negative "
                                 "integer")
            out["max_faults"] = v
        if "script" in obj:
            entries = obj["script"]
            if not isinstance(entries, (list, tuple)):
                raise ValueError("'script' must be an array")
            parsed = []
            for e in entries:
                if (not isinstance(e, dict)
                        or not isinstance(e.get("tick"), int)
                        or isinstance(e.get("tick"), bool)
                        or e.get("site") not in FAULT_SITES):
                    raise ValueError(
                        "each script entry must be {'tick': int, 'site': "
                        f"one of {list(FAULT_SITES)}, 'slot': int?}}")
                if "slot" in e and (isinstance(e["slot"], bool)
                                    or not isinstance(e["slot"], int)):
                    raise ValueError("'slot' must be an integer")
                parsed.append({"tick": e["tick"], "site": e["site"],
                               **({"slot": e["slot"]} if "slot" in e
                                  else {})})
            out["script"] = tuple(parsed)
        return cls(**out)

    @property
    def armed(self) -> bool:
        return bool(self.script or self.admission_rate or self.chunk_rate
                    or self.stall_rate or self.kill_rate)


class FaultPlane:
    """Runtime for one :class:`FaultSpec`. Checked only from the thread
    driving the scheduler tick, so no locking on the draw path; ``fired``
    counters are plain ints read by stats."""

    def __init__(self, spec: Optional[FaultSpec] = None):
        self.spec = FaultSpec.from_json(spec) if not isinstance(
            spec, FaultSpec) else spec
        self._rng = random.Random(self.spec.seed)
        self._script = list(self.spec.script)
        self.fired: Dict[str, int] = {s: 0 for s in FAULT_SITES}

    def _budget_left(self) -> bool:
        if self.spec.max_faults is None:
            return True
        return sum(self.fired.values()) < self.spec.max_faults

    def _take_scripted(self, tick: int, sites: Tuple[str, ...]
                       ) -> Optional[Dict[str, Any]]:
        for i, e in enumerate(self._script):
            if e["tick"] == tick and e["site"] in sites:
                return self._script.pop(i)
        return None

    def _fire(self, site: str):
        self.fired[site] += 1

    def check_admission(self, tick: int):
        """Called immediately before ``engine.insert_request`` — a raise
        here faults the admission with the engine untouched (the conserva-
        tive model: a real admission fault additionally gets a defensive
        slot release from the scheduler)."""
        e = self._take_scripted(tick, ("admission",))
        if e is None and self.spec.admission_rate and self._budget_left() \
                and self._rng.random() < self.spec.admission_rate:
            e = {"site": "admission"}
        if e is not None:
            self._fire("admission")
            raise InjectedFault("admission", tick=tick)

    def check_chunk(self, tick: int, slots: List[int]):
        """Called immediately before a fused chunk dispatch. May kill the
        worker (:class:`WorkerKill`), stall (sleep through the tick), or
        raise an :class:`InjectedFault` naming one victim slot."""
        e = self._take_scripted(tick, ("kill", "stall", "chunk"))
        if e is None and self._budget_left():
            draw = self._rng.random()
            if self.spec.kill_rate and draw < self.spec.kill_rate:
                e = {"site": "kill"}
            elif self.spec.stall_rate and draw < self.spec.stall_rate:
                e = {"site": "stall"}
            elif self.spec.chunk_rate and draw < self.spec.chunk_rate:
                e = {"site": "chunk"}
        if e is None:
            return
        site = e["site"]
        self._fire(site)
        if site == "kill":
            raise WorkerKill(f"injected worker kill at tick {tick}")
        if site == "stall":
            time.sleep(self.spec.stall_s)
            return
        slot = e.get("slot")
        if slot is None and slots:
            slot = slots[self._rng.randrange(len(slots))]
        raise InjectedFault("chunk", tick=tick, slot=slot)

    def stats(self) -> Dict[str, Any]:
        return {"armed": self.spec.armed, "fired": dict(self.fired),
                "script_pending": len(self._script)}


# ---------------------------------------------------------------------------
# Brownout degradation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BrownoutConfig:
    """Thresholds for the NORMAL -> SOFT -> HARD state machine. Queue
    pressure is a fraction of the admission queue bound; event signals
    (pool exhaustions, tick stalls, engine faults) are counted over a
    sliding ``window_s``. Escalation requires the pressure to sustain
    ``escalate_s``; de-escalation (one step at a time) requires
    ``cool_s`` of calm — hysteresis, so the state cannot flap per tick."""

    queue_soft: float = 0.75
    queue_hard: float = 1.5
    exhaust_soft: int = 2
    exhaust_hard: int = 8
    stall_soft: int = 1
    fault_soft: int = 3
    window_s: float = 2.0
    escalate_s: float = 0.1
    cool_s: float = 1.0
    clamp_tokens: Optional[int] = 32      # SOFT: max_new_tokens ceiling
    retry_after_s: float = 1.0

    _ALLOWED = ("queue_soft", "queue_hard", "exhaust_soft", "exhaust_hard",
                "stall_soft", "fault_soft", "window_s", "escalate_s",
                "cool_s", "clamp_tokens", "retry_after_s")

    @classmethod
    def from_json(cls, obj: Optional[Dict[str, Any]]) -> "BrownoutConfig":
        if obj is None:
            return cls()
        if isinstance(obj, BrownoutConfig):
            return obj
        if not isinstance(obj, dict):
            raise ValueError("'brownout' must be an object")
        unknown = set(obj) - set(cls._ALLOWED)
        if unknown:
            raise ValueError(f"unknown brownout keys: {sorted(unknown)} "
                             f"(allowed: {list(cls._ALLOWED)})")
        out: Dict[str, Any] = {}
        for key in ("queue_soft", "queue_hard", "window_s", "escalate_s",
                    "cool_s", "retry_after_s"):
            if key in obj:
                v = obj[key]
                if isinstance(v, bool) or not isinstance(v, (int, float)) \
                        or v <= 0:
                    raise ValueError(f"{key!r} must be a positive number")
                out[key] = float(v)
        for key in ("exhaust_soft", "exhaust_hard", "stall_soft",
                    "fault_soft"):
            if key in obj:
                v = obj[key]
                if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                    raise ValueError(f"{key!r} must be a positive integer")
                out[key] = v
        if "clamp_tokens" in obj:
            v = obj["clamp_tokens"]
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int) or v < 1):
                raise ValueError("'clamp_tokens' must be a positive "
                                 "integer or null")
            out["clamp_tokens"] = v
        return cls(**out)


class BrownoutController:
    """Pressure-driven degradation state machine.

    The service worker feeds pressure events (:meth:`note`) and evaluates
    transitions (:meth:`observe`) once per loop iteration — no per-token
    cost. Request threads consult :meth:`admit` at admission, which also
    re-evaluates with the current queue so an idle service de-escalates
    even when the worker sleeps. All mutation happens under one lock;
    every method takes an optional explicit ``now`` so tests drive the
    clock deterministically."""

    def __init__(self, cfg: Optional[BrownoutConfig] = None, *,
                 metrics=None, model_id: str = ""):
        self.cfg = cfg if isinstance(cfg, BrownoutConfig) \
            else BrownoutConfig.from_json(cfg)
        self.state = "normal"
        self.transitions = 0
        self.shed = 0                       # requests rejected by brownout
        self._events: deque = deque()       # (t, kind) within window_s
        self._level_since: Dict[int, Optional[float]] = {1: None, 2: None}
        self._calm_since: Optional[float] = None
        self._forced: Optional[str] = None
        self._lock = threading.Lock()
        self._metrics = metrics
        self._model_id = model_id

    # -- signals -----------------------------------------------------------

    def note(self, kind: str, n: int = 1, *, now: Optional[float] = None):
        """Record ``n`` pressure events of ``kind`` (``pool_exhausted`` |
        ``stall`` | ``fault``)."""
        if n <= 0:
            return
        t = _now() if now is None else now
        with self._lock:
            for _ in range(n):
                self._events.append((t, kind))

    def _windowed(self, t: float) -> Dict[str, int]:
        cutoff = t - self.cfg.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()
        counts: Dict[str, int] = {}
        for _, kind in self._events:
            counts[kind] = counts.get(kind, 0) + 1
        return counts

    def _level(self, queue_frac: float, counts: Dict[str, int]) -> int:
        cfg = self.cfg
        if (queue_frac >= cfg.queue_hard
                or counts.get("pool_exhausted", 0) >= cfg.exhaust_hard):
            return 2
        if (queue_frac >= cfg.queue_soft
                or counts.get("pool_exhausted", 0) >= cfg.exhaust_soft
                or counts.get("stall", 0) >= cfg.stall_soft
                or counts.get("fault", 0) >= cfg.fault_soft):
            return 1
        return 0

    def _set_state(self, state: str):
        if state == self.state:
            return
        self.state = state
        self.transitions += 1
        if self._metrics is not None:
            self._metrics.inc("max_brownout_transitions_total",
                              model=self._model_id, to=state)

    def observe(self, queue_frac: float, *, now: Optional[float] = None
                ) -> str:
        """Evaluate a transition from the instantaneous queue pressure and
        the windowed event counts; returns the (possibly new) state."""
        t = _now() if now is None else now
        with self._lock:
            if self._forced is not None:
                self._set_state(self._forced)
                return self.state
            level = self._level(queue_frac, self._windowed(t))
            cur = BROWNOUT_STATES.index(self.state)
            cfg = self.cfg
            # sustained-escalation clocks, one per target level
            for lv in (1, 2):
                if level >= lv:
                    if self._level_since[lv] is None:
                        self._level_since[lv] = t
                else:
                    self._level_since[lv] = None
            if level > cur:
                since = self._level_since[min(level, 2)]
                if since is not None and t - since >= cfg.escalate_s:
                    self._set_state(BROWNOUT_STATES[level])
                    self._calm_since = None
            elif level < cur:
                if self._calm_since is None:
                    self._calm_since = t
                elif t - self._calm_since >= cfg.cool_s:
                    self._set_state(BROWNOUT_STATES[cur - 1])
                    self._calm_since = t  # one step per cool_s
            else:
                self._calm_since = None
            return self.state

    def force(self, state: Optional[str]):
        """Pin the state (operator override / tests); ``None`` releases."""
        if state is not None and state not in BROWNOUT_STATES:
            raise ValueError(f"unknown brownout state {state!r}")
        with self._lock:
            self._forced = state
            if state is not None:
                self._set_state(state)

    # -- admission ---------------------------------------------------------

    def admit(self, priority: str, *, now: Optional[float] = None):
        """Admission-time verdict. Raises :class:`~repro_torch.serving.qos.
        CircuitOpen` in HARD, :class:`~repro_torch.serving.qos.Degraded` for
        ``best_effort`` work in SOFT; returns None when admitted."""
        state = self.state
        if state == "hard":
            with self._lock:
                self.shed += 1
            if self._metrics is not None:
                self._metrics.inc("max_brownout_shed_total",
                                  model=self._model_id, state="hard")
            raise CircuitOpen(
                "circuit open: service is in HARD brownout "
                f"(retry after {self.cfg.retry_after_s}s)",
                retry_after_s=self.cfg.retry_after_s)
        if state == "soft" and priority == "best_effort":
            with self._lock:
                self.shed += 1
            if self._metrics is not None:
                self._metrics.inc("max_brownout_shed_total",
                                  model=self._model_id, state="soft")
            raise Degraded(
                "service degraded (SOFT brownout): best_effort work is "
                f"shed at admission (retry after {self.cfg.retry_after_s}s)",
                retry_after_s=self.cfg.retry_after_s)

    def clamp(self, max_new_tokens: Optional[int]) -> Optional[int]:
        """SOFT-state ceiling on generation budgets (HARD never admits)."""
        if (self.state == "soft" and self.cfg.clamp_tokens is not None
                and max_new_tokens is not None):
            return min(int(max_new_tokens), self.cfg.clamp_tokens)
        return max_new_tokens

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state, "transitions": self.transitions,
                    "shed": self.shed,
                    "window_events": len(self._events)}
