"""Inference services — the execution strategy behind a deployment
(counterpart of ``repro/core/service.py``).

- :class:`SyncService`     the request thread runs the wrapper directly
                           (one generation at a time on its engine, one
                           host read per token).
- :class:`BatchedService`  owns a :class:`ContinuousBatchingScheduler` on
                           a background worker thread; concurrent requests
                           land in a QoS admission queue, a short
                           *batching window* lets simultaneous arrivals
                           coalesce, and the engine decodes them as ONE
                           batch.

Admission is governed by an
:class:`~repro_torch.serving.qos.AdmissionController` (priority classes,
per-client deficit-weighted fairness, token-bucket rate limits, deadline
shedding); both services record every outcome in a shared
:class:`~repro_torch.serving.metrics.MetricsRegistry` and trace requests
with a :class:`~repro_torch.serving.tracing.Tracer`.

The envelopes are the JAX package's (``{"status": "ok", "predictions":
..., "model_id": ..., "latency_ms": ...}`` or a structured error), so a
caller cannot tell the two packages apart. Both services support async
*jobs* (submit -> poll -> attach) whose finished records expire after
``job_ttl_s``, and ``predict_stream``: an iterator of
:class:`~repro_torch.core.router.StreamEvent`. ``SyncService`` streams the
whole result as one ``token`` event; ``BatchedService`` bridges the
scheduler worker to the HTTP thread through a bounded per-request queue
fed at chunk boundaries (a consumer that stops draining, or closes the
iterator, cancels its request, so a dead stream never pins a decode
slot). Every job owns a :class:`JobStream`, a bounded replay buffer that
late subscribers attach to and resume from a sequence cursor.

Only the scheduler's worker thread touches CUDA tensors: stream events,
job results and metrics carry Python ints and strings.

Robustness (``BatchedService``): an optional
:class:`~repro_torch.serving.faults.FaultPlane` injects deterministic
faults at the scheduler's boundaries; a request retired as
``ENGINE_FAULT`` before any of its tokens reached a stream or a job
buffer is requeued with exponential backoff (greedy decode makes the
retry token-identical; its deadline stays absolute); a watchdog thread
flags ticks over ``stall_budget_s`` and respawns a dead worker;
``rebuild_after_faults`` consecutive faults rebuild the engine's state;
a :class:`~repro_torch.serving.faults.BrownoutController` sheds
best_effort work (SOFT) or all work (HARD) under sustained pressure;
``health()`` backs ``GET /v2/health``. The watchdog touches no device
state: a respawn flags the recovery (quarantine the active slots, reset
the engine) and the new worker runs it before its first tick.
"""

from __future__ import annotations

import abc
import queue as _queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

from repro_torch.core.router import StreamEvent
from repro_torch.core.wrapper import MAXError, MAXModelWrapper, PromptTooLong
from repro_torch.serving.faults import (
    BROWNOUT_STATES, BrownoutController, FaultPlane, FaultSpec, WorkerKill,
)
from repro_torch.serving.metrics import TOKEN_LATENCY_BUCKETS, MetricsRegistry
from repro_torch.serving.qos import (
    AdmissionController, AdmissionError, QoSConfig, QueueFull,
)
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.serving.tracing import Tracer, now as _mono


class ServiceOverloaded(MAXError):
    """Bounded request queue is full — client should back off (HTTP 429)."""


#: request-scoped QoS fields accepted by predict/predict_batch/submit_job
QOS_KEYS = ("priority", "client", "deadline_s")


def _qos_field(qos: Optional[Dict[str, Any]], key: str):
    return qos.get(key) if qos else None


# ---------------------------------------------------------------------------
# Async jobs (submit -> poll -> attach), shared by both service kinds.
# ---------------------------------------------------------------------------

class JobStream:
    """Bounded per-job event log with live fan-out.

    The producing side (scheduler token sink / job worker) ``push``es
    events; any number of subscribers replay the buffered events from a
    sequence cursor and then follow live pushes — the mechanism behind
    ``GET /v2/jobs/{id}/events`` and its ``Last-Event-ID``/``?from_seq=``
    resume. The buffer keeps the most recent ``maxlen`` events (a resume
    pointing before the retained window just gets what is still held); a
    terminal ``done``/``error`` event closes the stream and releases every
    subscriber.
    """

    def __init__(self, maxlen: int = 1024):
        self._buf: deque = deque(maxlen=maxlen)
        self._cv = threading.Condition()
        self._next_seq = 0
        self._closed = False

    def push(self, event: str, data: Dict[str, Any]) -> Optional[StreamEvent]:
        with self._cv:
            if self._closed:          # late results after a cancel race
                return None
            ev = StreamEvent(event, data, self._next_seq)
            self._next_seq += 1
            self._buf.append(ev)
            if event in ("done", "error"):
                self._closed = True
            self._cv.notify_all()
            return ev

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def subscribe(self, from_seq: int = 0, *,
                  timeout_s: float = 300.0) -> Iterator[StreamEvent]:
        """Yield events with ``seq >= from_seq``: buffered ones first, then
        live until the terminal event (or ``timeout_s`` of silence, which
        yields a structured ``error`` event and stops)."""
        next_seq = from_seq
        while True:
            with self._cv:
                batch = [e for e in self._buf if e.seq >= next_seq]
                while not batch and not self._closed:
                    if not self._cv.wait(timeout_s):
                        break                     # silence: stop below
                    batch = [e for e in self._buf if e.seq >= next_seq]
                closed = self._closed
            if not batch:
                if not closed:
                    # synthetic frame: seq next_seq-1, NOT next_seq — a
                    # client resuming with this id as Last-Event-ID must
                    # land back on the real event that will get next_seq
                    yield StreamEvent("error", {
                        "code": "TIMEOUT",
                        "message": f"no job events for {timeout_s}s"},
                        next_seq - 1)
                return
            for ev in batch:
                yield ev
                next_seq = ev.seq + 1
            if closed:                # the batch ended in the terminal event
                return


@dataclass
class Job:
    id: str
    model_id: str
    state: str = "queued"     # queued | running | done | error | cancelled
    # reported wall-clock stamps (API surface); never used for arithmetic
    submitted_at: float = field(default_factory=time.time)
    finished_at: Optional[float] = None
    finished_mono: Optional[float] = None   # tracing.now stamp; drives TTL GC
    result: Optional[Any] = None      # envelope when done
    error: Optional[str] = None
    stream: JobStream = field(default_factory=JobStream, repr=False)
    cancel_requested: bool = False    # sync running jobs honor it post-hoc
    trace_id: Optional[int] = None    # RequestTrace id when tracing is on

    def to_json(self) -> Dict[str, Any]:
        out = {"id": self.id, "model_id": self.model_id, "state": self.state,
               "submitted_at": self.submitted_at}
        if self.finished_at is not None:
            out["finished_at"] = self.finished_at
        if self.result is not None:
            out["result"] = self.result
        if self.error is not None:
            out["error"] = self.error
        return out


class InferenceService(abc.ABC):
    """Uniform predict/predict_batch/jobs surface over one wrapped model."""

    kind: str = "abstract"
    retain_jobs: int = 512            # finished jobs kept for polling

    def __init__(self, wrapper: MAXModelWrapper, *,
                 qos: Optional[Any] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 job_ttl_s: Optional[float] = None,
                 trace: bool = True, trace_buffer: int = 256,
                 slow_trace_ms: Optional[float] = None):
        self.wrapper = wrapper
        self.qos_cfg = qos if isinstance(qos, QoSConfig) \
            else QoSConfig.from_json(qos)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.job_ttl_s = job_ttl_s
        # request-lifecycle tracing: bounded ring of finished traces;
        # slow_trace_ms turns on slow-request capture (fast traces compact
        # under ring pressure, slow ones keep full span detail)
        self.tracer: Optional[Tracer] = Tracer(
            capacity=trace_buffer, slow_trace_ms=slow_trace_ms,
            model=wrapper.metadata.id) if trace else None
        self.admission = AdmissionController(
            self.qos_cfg, metrics=self.metrics,
            model_id=wrapper.metadata.id)
        for name, help_text in (
            ("max_ttft_seconds",
             "Time to first token from submit, per model"),
            ("max_inter_token_seconds",
             "Mean per-token interval of each decode chunk"),
            ("max_active_streams",
             "Currently open SSE token streams"),
            ("max_phase_queue_seconds",
             "Per-request queue/admission wait, by priority class"),
            ("max_phase_prefill_seconds",
             "Per-request prefill span (admission to first token), by "
             "priority class"),
            ("max_decode_per_token_seconds",
             "Per-request decode span divided by tokens generated, by "
             "priority class"),
            ("max_e2e_latency_seconds",
             "Per-request end-to-end latency (submit to retire), by "
             "priority class"),
        ):
            self.metrics.describe(name, help_text)
        self._jobs: Dict[str, Job] = {}
        self._jobs_lock = threading.Lock()
        # streaming accounting (both kinds): instantaneous gauge + totals
        self._streams_lock = threading.Lock()
        self._active_streams = 0
        self.streams_started = 0
        self.streams_cancelled = 0
        self.jobs_cancelled = 0
        self.metrics.register_gauge(
            "max_active_streams", lambda: self._active_streams,
            model=wrapper.metadata.id)

    @property
    def model_id(self) -> str:
        return self.wrapper.metadata.id

    def _request_cost(self, inp: Any) -> float:
        """Admission cost of one input — parses the generation-style dict
        field and delegates the pricing rule to
        :meth:`QoSConfig.request_cost` (shared with the scheduler, so both
        service kinds price identical traffic identically)."""
        if not self.wrapper.supports_generation():
            return self.qos_cfg.request_cost(1)   # classifiers: one unit
        budget = None
        if isinstance(inp, dict):
            try:
                budget = int(inp["max_new_tokens"])
            except (KeyError, TypeError, ValueError):
                budget = None
        return self.qos_cfg.request_cost(budget)

    def _count_request(self, priority: Optional[str],
                       env: Dict[str, Any]):
        """One requests_total increment per finished request; rejections
        are counted by the admission controller at submit time, so the sum
        over outcomes equals total submit attempts."""
        outcome = "ok" if env.get("status") == "ok" \
            else str(env.get("code") or "error").lower()
        self.metrics.inc(
            "max_requests_total", 1,
            **{"model": self.model_id, "outcome": outcome,
               "class": priority or self.qos_cfg.default_priority})

    def _observe_phases(self, priority: Optional[str],
                        usage: Optional[Dict[str, Any]]):
        """Phase histograms (queue wait / prefill / per-token decode /
        e2e) labelled by priority class, fed from the usage record both
        service kinds already compute — no extra stamps."""
        if not usage:
            return
        labels = {"model": self.model_id,
                  "class": priority or self.qos_cfg.default_priority}
        if usage.get("queue_ms") is not None:
            self.metrics.observe("max_phase_queue_seconds",
                                 usage["queue_ms"] / 1e3, **labels)
        if usage.get("prefill_ms"):
            self.metrics.observe("max_phase_prefill_seconds",
                                 usage["prefill_ms"] / 1e3, **labels)
        toks = usage.get("completion_tokens")
        if usage.get("decode_ms") and toks:
            self.metrics.histogram(
                "max_decode_per_token_seconds",
                buckets=TOKEN_LATENCY_BUCKETS, **labels,
            ).observe(usage["decode_ms"] / 1e3 / toks)
        if usage.get("latency_ms") is not None:
            self.metrics.observe("max_e2e_latency_seconds",
                                 usage["latency_ms"] / 1e3, **labels)

    # -- predictions -------------------------------------------------------

    @abc.abstractmethod
    def predict(self, inp: Any,
                qos: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Return the standardized envelope for one input. ``qos`` carries
        request-scoped fields (:data:`QOS_KEYS`)."""

    def predict_batch(self, inputs: List[Any],
                      qos: Optional[Dict[str, Any]] = None
                      ) -> List[Dict[str, Any]]:
        """Per-input envelopes for an explicit multi-input request."""
        return [self.predict(i, qos) for i in inputs]

    # -- streaming ---------------------------------------------------------

    @abc.abstractmethod
    def predict_stream(self, inp: Any,
                       qos: Optional[Dict[str, Any]] = None
                       ) -> Iterator[StreamEvent]:
        """Iterator of :class:`StreamEvent` for one input: ``token`` deltas
        (monotone per-stream ``seq``), then a terminal ``done`` carrying
        the same envelope ``predict`` would return plus usage — or an
        ``error`` event with a structured code. Closing the iterator
        mid-stream cancels the underlying work."""

    def _stream_opened(self):
        with self._streams_lock:
            self._active_streams += 1
            self.streams_started += 1

    def _stream_closed(self, cancelled: bool = False):
        with self._streams_lock:
            self._active_streams -= 1
            if cancelled:
                self.streams_cancelled += 1

    @staticmethod
    def _terminal_event_data(envelope: Dict[str, Any],
                             usage: Optional[Dict[str, Any]] = None
                             ) -> tuple:
        """(event_name, data) for a finished request's terminal event."""
        status = envelope.get("status")
        if status == "ok":
            return "done", {"envelope": envelope, "usage": usage}
        code = envelope.get("code") or (
            "CANCELLED" if status == "cancelled" else "INTERNAL")
        err = envelope.get("error")
        if isinstance(err, dict):
            err = err.get("message", str(err))
        return "error", {"code": code, "message": str(err or "failed"),
                         "envelope": envelope, "usage": usage}

    # -- jobs --------------------------------------------------------------

    def _new_job(self) -> Job:
        job = Job(id=uuid.uuid4().hex[:12], model_id=self.model_id)
        with self._jobs_lock:
            self._jobs[job.id] = job
        return job

    def _gc_jobs_locked(self):
        """Expire finished jobs past the TTL and enforce the count bound
        (``_jobs_lock`` held)."""
        finished = [jid for jid, j in self._jobs.items()
                    if j.state in ("done", "error")]
        if self.job_ttl_s is not None:
            # monotonic clock: a host wall-clock step must not mass-expire
            # (step forward) or immortalize (step back) finished jobs
            cutoff = _mono() - self.job_ttl_s
            for jid in finished:
                if (self._jobs[jid].finished_mono or 0) < cutoff:
                    del self._jobs[jid]
            finished = [jid for jid in finished if jid in self._jobs]
        # bounded retention, like the scheduler's completed map: evict
        # the oldest finished jobs so records don't grow with uptime
        for jid in finished[:max(0, len(finished) - self.retain_jobs)]:
            del self._jobs[jid]

    def _finish_job(self, job: Job, envelope: Dict[str, Any],
                    usage: Optional[Dict[str, Any]] = None,
                    token_event: Optional[Dict[str, Any]] = None):
        """``token_event`` (the sync whole-result fallback) is pushed only
        after the locked cancel resolution decides the result stands — a
        cancelled job must not leak its discarded output to subscribers."""
        with self._jobs_lock:
            if job.cancel_requested and envelope.get("status") != "cancelled":
                # cancel raced completion: cancel_job set the flag under
                # this lock while the job was still live and already
                # answered 200 "cancelled" — that answer must win over
                # the late result (checked here, under the same lock, so
                # there is no window for a 'done' record to slip through)
                envelope = {"status": "cancelled", "code": "CANCELLED",
                            "error": "cancelled while running",
                            "model_id": self.model_id}
                usage = None
            status = envelope.get("status")
            # state flips LAST: pollers read without the lock, and a job
            # observed as done/error must already carry result+finished_at
            job.result = envelope
            job.error = envelope.get("error") if status != "ok" else None
            if isinstance(job.error, dict):     # structured error message
                job.error = job.error.get("message", str(job.error))
            job.finished_at = time.time()
            job.finished_mono = _mono()
            job.state = "done" if status == "ok" \
                else "cancelled" if status == "cancelled" else "error"
            self._gc_jobs_locked()
        if job.state == "cancelled":
            with self._streams_lock:    # += races worker/request threads
                self.jobs_cancelled += 1
        # stream events outside the lock (JobStream has its own cv); the
        # state flip above makes any later cancel_job return False, so
        # this ordering cannot race a cancel
        if token_event is not None and job.state == "done":
            job.stream.push("token", token_event)
        event, data = self._terminal_event_data(envelope, usage)
        job.stream.push(event, data)

    @abc.abstractmethod
    def submit_job(self, inp: Any,
                   qos: Optional[Dict[str, Any]] = None) -> Job:
        """Enqueue ``inp`` for asynchronous prediction; returns immediately."""

    def get_job(self, job_id: str) -> Job:
        with self._jobs_lock:
            self._gc_jobs_locked()
            try:
                return self._jobs[job_id]
            except KeyError:
                raise KeyError(f"unknown job {job_id!r}") from None

    def delete_job(self, job_id: str) -> bool:
        """Drop a *finished* job's record (``DELETE /v2/jobs/{id}`` falls
        through to this after :meth:`cancel_job` declines — queued/running
        jobs are cancelled, not silently unrecorded)."""
        with self._jobs_lock:
            return self._jobs.pop(job_id, None) is not None

    @abc.abstractmethod
    def cancel_job(self, job_id: str) -> bool:
        """Cancel a queued or running job: the job finishes with state
        ``cancelled`` and envelope ``{"status": "cancelled", ...}``, and
        any decode slot it held is freed at the next chunk boundary.
        Returns False when the job is unknown or already finished."""

    def job_events(self, job_id: str, from_seq: int = 0,
                   *, timeout_s: float = 300.0) -> Iterator[StreamEvent]:
        """Attach to a job's event stream (replay + live); raises KeyError
        for unknown jobs like :meth:`get_job`."""
        return self.get_job(job_id).stream.subscribe(
            from_seq, timeout_s=timeout_s)

    def get_trace(self, job_id: str) -> Dict[str, Any]:
        """Span timeline JSON for a job's request. Raises KeyError for
        unknown jobs (like :meth:`get_job`), for jobs submitted before
        tracing was enabled, and for traces the bounded ring evicted."""
        job = self.get_job(job_id)
        if self.tracer is None:
            raise KeyError(
                f"tracing is disabled for {self.model_id!r} "
                "(redeploy with {\"trace\": true})")
        if job.trace_id is None:
            raise KeyError(f"job {job_id!r} has no trace record")
        trace = self.tracer.get(job.trace_id)
        if trace is None:
            raise KeyError(
                f"trace for job {job_id!r} was evicted from the "
                f"{self.tracer.capacity}-entry ring")
        return trace

    # -- lifecycle / introspection ----------------------------------------

    def health(self) -> Dict[str, Any]:
        """Liveness/readiness/degradation for ``GET /v2/health``. A sync
        service is live and ready while open (the request thread does the
        work, there is no worker to die); the batched service overrides
        this with its worker and brownout state."""
        open_ = not getattr(self, "_closed", False)
        return {"live": open_, "ready": open_, "degradation": "normal"}

    def stats(self) -> Dict[str, Any]:
        with self._jobs_lock:
            self._gc_jobs_locked()
            jobs = len(self._jobs)
        with self._streams_lock:
            streams = {"active": self._active_streams,
                       "started": self.streams_started,
                       "cancelled": self.streams_cancelled}
        return {"kind": self.kind, "jobs": jobs,
                "job_ttl_s": self.job_ttl_s,
                "cancelled": self.jobs_cancelled,
                "streams": streams,
                "ttft": self.metrics.histogram(
                    "max_ttft_seconds", model=self.model_id).snapshot(),
                "inter_token": self.metrics.histogram(
                    "max_inter_token_seconds",
                    buckets=TOKEN_LATENCY_BUCKETS,
                    model=self.model_id).snapshot(),
                "tracing": (self.tracer.snapshot_stats()
                            if self.tracer is not None
                            else {"enabled": False}),
                "qos": self.admission.stats()}

    def close(self):
        self.metrics.unregister_gauges(model=self.model_id)


# ---------------------------------------------------------------------------
# SyncService — v1 semantics behind the uniform interface.
# ---------------------------------------------------------------------------

class SyncService(InferenceService):
    kind = "sync"

    def __init__(self, wrapper: MAXModelWrapper, **kw):
        super().__init__(wrapper, **kw)
        # generation wrappers keep decode-slot state on their engine; two
        # HTTP threads calling predict concurrently would race on it, so
        # those run one call at a time. Stateless wrappers stay concurrent.
        self._serialize = wrapper.supports_generation()
        self._predict_lock = threading.Lock()
        self._job_queue: deque = deque()
        self._job_cv = threading.Condition()
        self._job_thread: Optional[threading.Thread] = None
        self._closed = False

    def _admit_or_envelope(self, qos: Optional[Dict[str, Any]],
                           cost: float = 1.0) -> Optional[Dict[str, Any]]:
        """Sync admission = token-bucket + class validation only (there is
        no queue to prioritise — the request thread runs the call now)."""
        try:
            self.admission.try_acquire(
                _qos_field(qos, "client") or "anon", cost,
                _qos_field(qos, "priority"))
            return None
        except AdmissionError as e:
            # no _count_request here: rate-limits are already counted by
            # the controller (counting again would double the series), and
            # an invalid priority must not mint a metrics label from a
            # client-controlled string
            env = {"status": "error", "error": str(e), "code": e.code,
                   "model_id": self.model_id}
            if getattr(e, "retry_after_s", None) is not None:
                env["retry_after_s"] = e.retry_after_s
            return env

    @staticmethod
    def _first_prediction(env: Dict[str, Any]) -> Dict[str, Any]:
        preds = env.get("predictions")
        return preds[0] if isinstance(preds, list) and preds \
            and isinstance(preds[0], dict) else {}

    def _sync_usage(self, env: Dict[str, Any], latency_ms: float,
                    queue_ms: float = 0.0) -> Dict[str, Any]:
        """Usage for the whole-result fallback: token counts when the
        wrapper reports them, TTFT = engine-measured first token (sync
        generation) or the whole-call latency (classifiers). Phase fields
        mirror the batched service: sync has no scheduler queue (only job
        submissions wait, measured by ``queue_ms``), prefill is the
        engine-measured TTFT, decode the remainder."""
        first = self._first_prediction(env)
        ttft = first.get("ttft_ms", latency_ms)
        prefill = float(ttft) if ttft is not None else 0.0
        return {"prompt_tokens": first.get("prompt_tokens"),
                "completion_tokens": first.get("generated_tokens"),
                "ttft_ms": ttft,
                "latency_ms": latency_ms,
                "queue_ms": round(queue_ms, 3),
                "prefill_ms": round(min(prefill, latency_ms), 3),
                "decode_ms": round(max(0.0, latency_ms - prefill), 3),
                "sched_ticks": 0}

    def _sync_token_event(self, env: Dict[str, Any]) -> Dict[str, Any]:
        """The whole-result-as-one-event token payload (one grammar for
        /stream and /jobs/{id}/events alike)."""
        return {"text": self._first_prediction(env).get("generated_text"),
                "predictions": env.get("predictions"),
                "model_id": self.model_id}

    def _observe_ttft(self, env: Dict[str, Any]):
        """Sync TTFT: the engine's measured first-token time when the
        wrapper reports one (generation assets), else the whole-call
        latency (classifiers emit their one result all at once)."""
        if env.get("status") != "ok":
            return
        ttft_ms = self._first_prediction(env).get("ttft_ms",
                                                  env.get("latency_ms"))
        if ttft_ms is not None:
            self.metrics.observe("max_ttft_seconds", float(ttft_ms) / 1e3,
                                 model=self.model_id)

    def _start_sync_trace(self, qos: Optional[Dict[str, Any]],
                          ts: Optional[float] = None):
        if self.tracer is None:
            return None
        return self.tracer.start(
            self.tracer.next_id(),
            priority=(_qos_field(qos, "priority")
                      or self.qos_cfg.default_priority),
            client=_qos_field(qos, "client") or "anon",
            submitted_at=ts)

    def _finish_sync_trace(self, tr, env: Dict[str, Any], t_exec: float,
                           *, outcome: Optional[str] = None):
        """Close a sync trace from its envelope: first-token derived from
        the engine-measured TTFT (sync execution has no chunk boundary to
        stamp at), outcome from the envelope unless overridden (a cancel
        race resolved by ``_finish_job`` wins over the late result)."""
        if tr is None:
            return
        t_end = _mono()
        ttft_ms = self._first_prediction(env).get("ttft_ms")
        if env.get("status") == "ok" and ttft_ms is not None:
            tr.first_token(min(t_end, t_exec + float(ttft_ms) / 1e3))
        if outcome is None:
            outcome = "ok" if env.get("status") == "ok" \
                else str(env.get("code") or "INTERNAL")
        toks = self._first_prediction(env).get("generated_tokens") or 0
        self.tracer.finish(tr, outcome=outcome,
                           error_code=None if outcome == "ok" else outcome,
                           completion_tokens=int(toks), ts=t_end)

    def predict(self, inp: Any,
                qos: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        t0 = _mono()
        tr = self._start_sync_trace(qos, ts=t0)
        rejected = self._admit_or_envelope(qos, cost=self._request_cost(inp))
        if rejected is not None:
            if tr is not None:
                code = rejected.get("code") or "REJECTED"
                self.tracer.finish(tr, outcome=code, error_code=code)
            return rejected
        t_exec = _mono()
        if tr is not None:
            tr.admitted(t_exec, slot=-1, tick=-1)
        if self._serialize:
            with self._predict_lock:
                env = self.wrapper.predict_envelope(inp)
        else:
            env = self.wrapper.predict_envelope(inp)
        self._observe_ttft(env)
        self._count_request(_qos_field(qos, "priority"), env)
        if env.get("status") == "ok":
            self._observe_phases(
                _qos_field(qos, "priority"),
                self._sync_usage(env, round((_mono() - t0) * 1e3, 3)))
        self._finish_sync_trace(tr, env, t_exec)
        return env

    def predict_stream(self, inp: Any,
                       qos: Optional[Dict[str, Any]] = None
                       ) -> Iterator[StreamEvent]:
        """Whole-result-as-one-event fallback: sync execution has no chunk
        boundaries to stream from, so the stream is ``token`` (full
        payload) then ``done`` — the same event grammar as the batched
        service, so clients need not care which service kind answered."""
        def gen():
            self._stream_opened()
            try:
                t0 = _mono()
                env = self.predict(inp, qos)
                latency_ms = round((_mono() - t0) * 1e3, 3)
                if env.get("status") != "ok":
                    code = env.get("code") or "INVALID_INPUT"
                    yield StreamEvent("error", {
                        "code": code, "message": str(env.get("error")),
                        "model_id": self.model_id}, 0)
                    return
                yield StreamEvent("token", self._sync_token_event(env), 0)
                yield StreamEvent("done", {
                    "envelope": env,
                    "usage": self._sync_usage(env, latency_ms)}, 1)
            finally:
                self._stream_closed()
        return gen()

    def predict_batch(self, inputs: List[Any],
                      qos: Optional[Dict[str, Any]] = None
                      ) -> List[Dict[str, Any]]:
        rejected = self._admit_or_envelope(
            qos, cost=sum(self._request_cost(i) for i in inputs))
        if rejected is not None:
            return [dict(rejected) for _ in inputs]
        if self._serialize:
            with self._predict_lock:
                envs = self.wrapper.predict_batch_envelope(inputs)
        else:
            envs = self.wrapper.predict_batch_envelope(inputs)
        for env in envs:
            self._count_request(_qos_field(qos, "priority"), env)
        return envs

    def submit_job(self, inp: Any,
                   qos: Optional[Dict[str, Any]] = None) -> Job:
        # admission failures surface at submit (429), not as dead jobs
        self.admission.try_acquire(_qos_field(qos, "client") or "anon",
                                   self._request_cost(inp),
                                   _qos_field(qos, "priority"))
        job = self._new_job()
        tr = self._start_sync_trace(qos)    # queue span = submit -> pickup
        if tr is not None:
            job.trace_id = tr.trace_id
        with self._job_cv:
            if self._closed:
                with self._jobs_lock:
                    self._jobs.pop(job.id, None)
                if tr is not None:
                    self.tracer.finish(tr, outcome="INTERNAL",
                                       error_code="INTERNAL")
                raise MAXError(f"service for {self.model_id!r} is closed")
            if self._job_thread is None:        # lazy single worker
                self._job_thread = threading.Thread(
                    target=self._job_worker, daemon=True,
                    name=f"sync-jobs-{self.model_id}")
                self._job_thread.start()
            self._job_queue.append((job, inp, qos, tr))
            self._job_cv.notify()
        return job

    def _cancelled_envelope(self, detail: str) -> Dict[str, Any]:
        return {"status": "cancelled", "code": "CANCELLED",
                "error": f"cancelled {detail}", "model_id": self.model_id}

    def cancel_job(self, job_id: str) -> bool:
        """Queued jobs cancel immediately (dropped from the worker queue);
        a *running* sync job cannot be preempted mid-wrapper-call — the
        mark makes it finish as ``cancelled`` with its result discarded
        (there is no decode slot to reclaim in the sync service)."""
        with self._job_cv:
            for i, (job, _inp, _qos, tr) in enumerate(self._job_queue):
                if job.id == job_id:
                    del self._job_queue[i]
                    if tr is not None:
                        self.tracer.finish(tr, outcome="CANCELLED",
                                           error_code="CANCELLED")
                    self._finish_job(job,
                                     self._cancelled_envelope("while queued"))
                    return True
        with self._jobs_lock:
            job = self._jobs.get(job_id)
            if job is None or job.state not in ("queued", "running"):
                return False
            job.cancel_requested = True
        return True

    def _job_worker(self):
        while True:
            with self._job_cv:
                while not self._job_queue and not self._closed:
                    self._job_cv.wait()
                if self._closed:
                    return
                job, inp, qos, tr = self._job_queue.popleft()
            if job.cancel_requested:             # cancelled between queue
                if tr is not None:               # scan and pickup
                    self.tracer.finish(tr, outcome="CANCELLED",
                                       error_code="CANCELLED")
                self._finish_job(job,
                                 self._cancelled_envelope("while queued"))
                continue
            job.state = "running"
            try:
                # rate limit was paid at submit; run the wrapper directly
                t0 = _mono()
                if tr is not None:               # queue wait ends here
                    tr.admitted(t0, slot=-1, tick=-1)
                if self._serialize:
                    with self._predict_lock:
                        env = self.wrapper.predict_envelope(inp)
                else:
                    env = self.wrapper.predict_envelope(inp)
                self._observe_ttft(env)
                self._count_request(_qos_field(qos, "priority"), env)
            except Exception as e:              # fault isolation per job
                env = {"status": "error", "error": str(e),
                       "model_id": self.model_id}
            usage = token_event = None
            if env.get("status") == "ok":
                latency_ms = round((_mono() - t0) * 1e3, 3)
                usage = self._sync_usage(
                    env, latency_ms,
                    queue_ms=(t0 - tr.submitted_at) * 1e3
                    if tr is not None else 0.0)
                self._observe_phases(_qos_field(qos, "priority"), usage)
                token_event = self._sync_token_event(env)
            # a cancel that races this completion is resolved inside
            # _finish_job under the jobs lock: the record can never flip
            # to 'done' after cancel_job answered "cancelled", and the
            # whole-result token event is only pushed if the result stands
            self._finish_job(job, env, usage=usage, token_event=token_event)
            # trace outcome follows the resolved job state (a cancel race
            # answered "cancelled" — the trace must agree)
            self._finish_sync_trace(
                tr, env, t0,
                outcome="CANCELLED" if job.state == "cancelled" else None)

    def close(self):
        with self._job_cv:
            self._closed = True
            queued = list(self._job_queue)
            self._job_queue.clear()
            self._job_cv.notify_all()
        # fail undrained jobs now — pollers must not spin on 'queued' forever
        for job, _inp, _qos, tr in queued:
            if tr is not None:
                self.tracer.finish(tr, outcome="INTERNAL",
                                   error_code="INTERNAL")
            self._finish_job(job, {
                "status": "error",
                "error": f"service for {self.model_id!r} is closed",
                "model_id": self.model_id})
        super().close()


# ---------------------------------------------------------------------------
# BatchedService — the continuous-batching bridge.
# ---------------------------------------------------------------------------

@dataclass
class _Work:
    """One logical generation riding the scheduler."""
    prompt: List[int]
    gen_kw: Dict[str, Any]
    t0: float
    event: threading.Event = field(default_factory=threading.Event)
    job: Optional[Job] = None
    request: Optional[Any] = None     # scheduler Request once submitted
    envelope: Optional[Dict[str, Any]] = None
    # streaming plumbing: ``push(token_ids, text)`` forwards a chunk's
    # tokens, ``notify(envelope, usage)`` delivers the terminal result —
    # both run on the scheduler worker thread and must not block it
    push: Optional[Callable] = None
    notify: Optional[Callable] = None
    last_tok_t: Optional[float] = None   # previous sync-point timestamp
    # retry bookkeeping: a faulted request may requeue only while ZERO
    # tokens were delivered outside the service (to a stream bridge or a
    # job replay buffer); a token a client may have seen is never re-sent
    sink: Optional[Callable] = None      # token_sink, reused on resubmit
    qos: Optional[Dict[str, Any]] = None  # original QoS fields
    deadline_at: Optional[float] = None  # absolute: retries never extend it
    attempts: int = 0                    # completed (faulted) attempts
    delivered: int = 0                   # tokens pushed to an external sink


@dataclass
class BatchStats:
    """Service-level counters; batch sizes live on the scheduler's stats."""
    submitted: int = 0
    completed: int = 0
    rejected: int = 0                 # queue full + rate limited at submit
    cancelled: int = 0                # user cancel / disconnect / abandon


class BatchedService(InferenceService):
    """Aggregates concurrent requests into engine decode batches.

    A single worker thread owns the scheduler (and so the engine cache);
    request threads submit through the scheduler's admission controller
    (which may reject with ``QUEUE_FULL`` / ``RATE_LIMITED`` on the request
    thread) and wait on a per-request event, so no engine state is touched
    concurrently. ``batch_window_s`` is the coalescing window: when the
    engine is idle and a request arrives, the worker waits that long (or
    until the batch is full) for simultaneous arrivals before the first
    prefill, then keeps admitting newcomers every tick. Dequeue order is
    the controller's: priority classes, then deficit-weighted fairness
    across clients. ``decode_chunk`` is the fused-decode granularity (one
    host read per chunk). The robustness knobs (``faults``, ``brownout``,
    ``max_retries``, ``retry_backoff_s``, ``stall_budget_s``,
    ``rebuild_after_faults``, ``watchdog_interval_s``) take the JAX
    package's defaults."""

    kind = "batched"

    def __init__(self, wrapper: MAXModelWrapper, *,
                 batch_window_s: float = 0.01, max_queue: int = 64,
                 request_timeout_s: float = 300.0,
                 decode_chunk: Optional[int] = None,
                 stream_queue_depth: int = 256, seed: int = 0,
                 faults: Optional[Any] = None,
                 brownout: Optional[Any] = None,
                 max_retries: int = 3,
                 retry_backoff_s: float = 0.05,
                 stall_budget_s: float = 5.0,
                 rebuild_after_faults: int = 3,
                 watchdog_interval_s: float = 0.1, **kw):
        if not wrapper.supports_generation():
            raise ValueError(
                f"{wrapper.metadata.id!r} does not implement the generation "
                "protocol (prepare_generation/format_generation); "
                "use SyncService")
        if kw.get("qos") is None:
            kw["qos"] = QoSConfig(max_queue=max_queue)
        super().__init__(wrapper, **kw)
        self.engine = wrapper.engine
        # an unarmed spec attaches no plane at all: the scheduler's hooks
        # stay bare `is not None` checks
        spec = faults if isinstance(faults, FaultSpec) \
            else FaultSpec.from_json(faults)
        self.fault_plane: Optional[FaultPlane] = \
            FaultPlane(spec) if spec.armed else None
        self.scheduler = ContinuousBatchingScheduler(
            self.engine, admission=self.admission,
            decode_chunk=decode_chunk, tracer=self.tracer, seed=seed,
            faults=self.fault_plane)
        self.batch_window_s = batch_window_s
        self.max_queue = self.qos_cfg.max_queue
        self.request_timeout_s = request_timeout_s
        # bounded bridge between the scheduler worker and a stream's HTTP
        # thread: at ~1 event per decode chunk this holds minutes of
        # backlog, so hitting the bound means the consumer is gone
        self.stream_queue_depth = stream_queue_depth
        self.batch_stats = BatchStats()
        self._inflight: Dict[int, _Work] = {}
        self._cv = threading.Condition()
        self._closed = False
        self._worker_error: Optional[str] = None
        # -- supervision / retry / brownout --------------------------------
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = retry_backoff_s
        self.stall_budget_s = stall_budget_s
        self.rebuild_after_faults = max(0, int(rebuild_after_faults))
        self.watchdog_interval_s = watchdog_interval_s
        self._retry_q: List[tuple] = []   # (due on the serving clock, work)
        self.retries = 0
        self.worker_restarts = 0
        self.engine_rebuilds = 0
        self.tick_stalls = 0
        self._faults_seen = 0             # metric-delta mirrors
        self._pool_exhausted_seen = 0
        self._tick_started: Optional[float] = None
        self._stall_flagged = False
        # set by the watchdog for the next worker to run before its first
        # tick; a failed recovery holds readiness down until one succeeds
        self._recovery: Optional[str] = None
        self._recovery_error: Optional[str] = None
        self._brownout: Optional[BrownoutController] = None
        if brownout is not None:
            self._brownout = BrownoutController(
                brownout, metrics=self.metrics, model_id=self.model_id)
            self.metrics.register_gauge(
                "max_brownout_state",
                lambda: BROWNOUT_STATES.index(self._brownout.state),
                model=self.model_id)
        for name, help_text in (
            ("max_engine_faults_total",
             "Requests retired as ENGINE_FAULT (injected or real)"),
            ("max_retries_total",
             "Automatic requeues of zero-delivery faulted requests"),
            ("max_worker_restarts_total",
             "Dead scheduler workers respawned by the watchdog"),
            ("max_engine_rebuilds_total",
             "Engine state rebuilds after repeated faults"),
            ("max_tick_stalls_total",
             "Scheduler ticks that exceeded the stall budget"),
            ("max_brownout_transitions_total",
             "Brownout state-machine transitions, by target state"),
            ("max_brownout_shed_total",
             "Requests shed at admission by brownout degradation"),
            ("max_brownout_state",
             "Current degradation state (0=normal, 1=soft, 2=hard)"),
        ):
            self.metrics.describe(name, help_text)
        self.metrics.register_gauge(
            "max_queue_depth", self.admission.depth, model=self.model_id)
        if self.engine.paged:
            # pool occupancy: a paged deployment's device memory scales
            # with pages in use, not with max_batch * max_seq
            self.metrics.register_gauge(
                "max_kv_pool_blocks_in_use", self.engine.blocks_in_use,
                model=self.model_id)
            self.metrics.register_gauge(
                "max_kv_pool_blocks_total",
                lambda: self.engine.kv_pool_blocks, model=self.model_id)
        if self.engine.prefix_cache is not None:
            # prefix-cache effectiveness: counters rendered as gauges
            # (monotonic reads of host engine state, no write per event)
            def _pstat(key):
                return lambda: self.engine.prefix_stats()[key]
            for key in ("hits", "misses", "hit_tokens", "evictions",
                        "cow_copies"):
                self.metrics.register_gauge(
                    f"max_prefix_cache_{key}_total", _pstat(key),
                    model=self.model_id)
            for key in ("shared_pages", "cached_pages",
                        "unreferenced_pages"):
                self.metrics.register_gauge(
                    f"max_prefix_cache_{key}", _pstat(key),
                    model=self.model_id)
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name=f"batched-{self.model_id}")
        self._thread.start()
        # the watchdog outlives any one worker: it respawns dead workers
        # and flags ticks that blow the stall budget
        self._watchdog_thread = threading.Thread(
            target=self._watchdog, daemon=True,
            name=f"watchdog-{self.model_id}")
        self._watchdog_thread.start()

    # -- request path ------------------------------------------------------

    def _enqueue(self, inp: Any, job: Optional[Job] = None,
                 qos: Optional[Dict[str, Any]] = None,
                 push: Optional[Callable] = None,
                 notify: Optional[Callable] = None) -> _Work:
        prompt, gen_kw, extra = self.wrapper.prepare_generation(inp)
        # reject here, on the request thread: a zero-headroom prompt would
        # burn a prefill + slot only to retire with nothing generated
        if not self.engine.fits_prompt(len(prompt)):
            raise PromptTooLong(
                f"prompt of {len(prompt)} tokens does not fit max_seq "
                f"{self.engine.max_seq} with generation headroom (longest "
                f"admissible prompt: {self.engine.max_prompt_len()} tokens)")
        if extra:
            raise MAXError("extra model inputs are not ported yet")
        if self._brownout is not None:
            # re-evaluate with the live queue (an idle service cools down
            # while the worker sleeps), then shed or clamp: HARD raises
            # CircuitOpen for everyone, SOFT raises Degraded for
            # best_effort and caps the generation budget of the rest
            self._brownout.observe(self._queue_frac())
            self._brownout.admit(_qos_field(qos, "priority")
                                 or self.qos_cfg.default_priority)
            mnt = gen_kw.get("max_new_tokens")
            clamped = self._brownout.clamp(mnt if mnt is not None else 32)
            if clamped is not None and clamped != mnt:
                gen_kw = dict(gen_kw, max_new_tokens=clamped)
        work = _Work(prompt=prompt, gen_kw=gen_kw, t0=_mono(), job=job,
                     push=push, notify=notify,
                     qos=dict(qos) if qos else None)
        dl = _qos_field(qos, "deadline_s")
        if dl is not None:
            work.deadline_at = work.t0 + float(dl)

        def sink(toks: List[int]):
            # runs at the scheduler's host read (worker thread, scheduler
            # lock held) with Python ints: record per-token pacing, then
            # forward. The gap / len(toks) sample is the chunk's mean
            # inter-token interval.
            now = _mono()
            if work.last_tok_t is None:
                self.metrics.observe("max_ttft_seconds", now - work.t0,
                                     model=self.model_id)
            else:
                self.metrics.histogram(
                    "max_inter_token_seconds",
                    buckets=TOKEN_LATENCY_BUCKETS,
                    model=self.model_id,
                ).observe((now - work.last_tok_t) / len(toks))
            work.last_tok_t = now
            if work.push is not None:
                # handed to an external consumer: from here on a fault is
                # terminal for this request (a retry could duplicate what
                # the client already saw)
                work.delivered += len(toks)
                work.push(list(toks), self.wrapper.format_stream_delta(toks))

        work.sink = sink
        with self._cv:
            if self._closed:
                raise MAXError(f"service for {self.model_id!r} is closed")
            try:
                work.request = self.scheduler.submit(
                    prompt,
                    priority=_qos_field(qos, "priority"),
                    client=_qos_field(qos, "client"),
                    deadline_s=_qos_field(qos, "deadline_s"),
                    token_sink=sink,
                    **gen_kw)
            except QueueFull as e:
                self.batch_stats.rejected += 1
                raise ServiceOverloaded(str(e)) from None
            except AdmissionError:
                self.batch_stats.rejected += 1      # rate limited etc.
                raise
            if job is not None and self.tracer is not None:
                # the scheduler request IS the trace (same id), so
                # GET /v2/jobs/{id}/trace resolves through the job record
                job.trace_id = work.request.id
            self._inflight[work.request.id] = work
            self.batch_stats.submitted += 1
            self._cv.notify_all()
        return work

    def _error_envelope(self, msg: str, code: str = "INVALID_INPUT",
                        retry_after_s: Optional[float] = None
                        ) -> Dict[str, Any]:
        # "code" is consumed by the API layer (v2 maps it to a structured
        # error and an HTTP status); retry_after_s becomes Retry-After
        env = {"status": "error", "error": msg, "code": code,
               "model_id": self.model_id}
        if retry_after_s is not None:
            env["retry_after_s"] = retry_after_s
        return env

    def _enqueue_or_error(self, inp: Any, job: Optional[Job] = None,
                          qos: Optional[Dict[str, Any]] = None):
        try:
            return self._enqueue(inp, job, qos)
        except ServiceOverloaded as e:
            env = self._error_envelope(str(e), "QUEUE_FULL")
        except PromptTooLong as e:
            env = self._error_envelope(str(e), "PROMPT_TOO_LONG")
        except AdmissionError as e:
            env = self._error_envelope(
                str(e), e.code,
                retry_after_s=getattr(e, "retry_after_s", None))
        except MAXError as e:
            env = self._error_envelope(str(e))
        return env

    def _await(self, work) -> Dict[str, Any]:
        if isinstance(work, dict):              # rejected at enqueue
            return work
        if not work.event.wait(self.request_timeout_s):
            return self._error_envelope(
                f"timed out after {self.request_timeout_s}s", "TIMEOUT")
        return work.envelope

    def predict(self, inp: Any,
                qos: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return self._await(self._enqueue_or_error(inp, qos=qos))

    def predict_batch(self, inputs: List[Any],
                      qos: Optional[Dict[str, Any]] = None
                      ) -> List[Dict[str, Any]]:
        # enqueue all first so they share decode batches, then wait all
        return [self._await(w)
                for w in [self._enqueue_or_error(i, qos=qos)
                          for i in inputs]]

    def submit_job(self, inp: Any,
                   qos: Optional[Dict[str, Any]] = None) -> Job:
        job = self._new_job()

        def push(toks: List[int], text: Optional[str]):
            # feeds the job's replay buffer at each chunk boundary, so any
            # number of /v2/jobs/{id}/events subscribers can attach/resume
            job.stream.push("token", {"token_ids": toks, "text": text,
                                      "model_id": self.model_id})

        try:
            self._enqueue(inp, job=job, qos=qos, push=push)
        except (MAXError, AdmissionError):
            # bad input / full queue / rate limit fails the submit (HTTP
            # 4xx), not a 202 with a dead job
            with self._jobs_lock:
                self._jobs.pop(job.id, None)
            raise
        return job

    def cancel_job(self, job_id: str) -> bool:
        """Cancel via the scheduler: queued work is dropped from admission,
        a running slot is freed at the next chunk boundary (and backfilled
        in the same tick). The worker reaps the retired request and flips
        the job to ``cancelled``."""
        with self._cv:
            work = next((w for w in self._inflight.values()
                         if w.job is not None and w.job.id == job_id), None)
        if work is None or work.request is None:
            return False
        return self.scheduler.cancel(work.request.id)

    def predict_stream(self, inp: Any,
                       qos: Optional[Dict[str, Any]] = None
                       ) -> Iterator[StreamEvent]:
        """Live token stream for one input.

        The scheduler worker feeds a *bounded* queue at each chunk
        boundary; this generator (the HTTP thread) drains it. Closing the
        generator mid-stream (a client disconnect) cancels the request,
        as does a consumer that stops draining (``stream_queue_depth``
        events of backlog); the slot frees at the next chunk boundary.
        Admission rejection arrives as a pre-stream ``error`` event with
        its structured code."""
        def gen():
            bridge: _queue.Queue = _queue.Queue(
                maxsize=self.stream_queue_depth)
            box: Dict[str, Any] = {}

            def push(toks: List[int], text: Optional[str]):
                try:
                    bridge.put_nowait(
                        ("token", {"token_ids": toks, "text": text,
                                   "model_id": self.model_id}))
                except _queue.Full:
                    # abandoned consumer: free the slot instead of
                    # decoding into a queue nobody drains
                    req = box.get("request")
                    if req is not None:
                        self.scheduler.cancel(req.id)

            def notify(env, usage):
                event, data = self._terminal_event_data(env, usage)
                try:
                    bridge.put_nowait((event, data))
                except _queue.Full:     # guarantee the terminal lands
                    try:
                        bridge.get_nowait()
                    except _queue.Empty:
                        pass
                    bridge.put_nowait((event, data))

            self._stream_opened()
            cancelled = False
            seq = 0
            try:
                try:
                    work = self._enqueue(inp, qos=qos,
                                         push=push, notify=notify)
                except ServiceOverloaded as e:
                    yield StreamEvent("error", {
                        "code": "QUEUE_FULL", "message": str(e),
                        "model_id": self.model_id}, seq)
                    return
                except AdmissionError as e:
                    data = {"code": e.code, "message": str(e),
                            "model_id": self.model_id}
                    if getattr(e, "retry_after_s", None) is not None:
                        data["retry_after_s"] = e.retry_after_s
                    yield StreamEvent("error", data, seq)
                    return
                except PromptTooLong as e:
                    yield StreamEvent("error", {
                        "code": "PROMPT_TOO_LONG", "message": str(e),
                        "model_id": self.model_id}, seq)
                    return
                except MAXError as e:
                    yield StreamEvent("error", {
                        "code": "INVALID_INPUT", "message": str(e),
                        "model_id": self.model_id}, seq)
                    return
                box["request"] = work.request
                try:
                    while True:
                        try:
                            event, data = bridge.get(
                                timeout=self.request_timeout_s)
                        except _queue.Empty:
                            self.scheduler.cancel(work.request.id)
                            cancelled = True
                            yield StreamEvent("error", {
                                "code": "TIMEOUT",
                                "message": "no tokens for "
                                           f"{self.request_timeout_s}s",
                                "model_id": self.model_id}, seq)
                            return
                        ev = StreamEvent(event, data, seq)
                        seq += 1
                        yield ev
                        if event != "token":     # done | error: terminal
                            cancelled = data.get("code") == "CANCELLED" \
                                if event == "error" else False
                            return
                except GeneratorExit:
                    # consumer went away mid-stream: never pin the slot
                    if not work.event.is_set():
                        self.scheduler.cancel(work.request.id)
                    cancelled = True
                    raise
            finally:
                self._stream_closed(cancelled=cancelled)
        return gen()

    # -- worker ------------------------------------------------------------

    def _usage(self, work: _Work) -> Dict[str, Any]:
        req = work.request
        ttft_ms = None
        if req is not None and req.first_token_s is not None:
            ttft_ms = round((req.first_token_s - work.t0) * 1e3, 3)
        end = req.finished_at_s if req is not None \
            and req.finished_at_s is not None else _mono()
        usage = {"prompt_tokens": len(work.prompt),
                 "completion_tokens": len(req.output) if req else 0,
                 "ttft_ms": ttft_ms,
                 "latency_ms": round((end - work.t0) * 1e3, 3)}
        # phase durations from the scheduler's lifecycle stamps, all on the
        # one serving clock, each boundary shared by two phases, so
        # queue_ms + prefill_ms + decode_ms == retire - submit exactly
        sub = req.submitted_at_s or work.t0
        adm, ft = req.admitted_at_s, req.first_token_s
        usage["queue_ms"] = round(
            max(0.0, (adm if adm is not None else end) - sub) * 1e3, 3)
        usage["prefill_ms"] = round(
            max(0.0, (ft if ft is not None else end) - adm) * 1e3, 3) \
            if adm is not None else 0.0
        usage["decode_ms"] = round(max(0.0, end - ft) * 1e3, 3) \
            if ft is not None else 0.0
        usage["sched_ticks"] = (req.finished_at_tick
                                - req.admitted_at_tick + 1) \
            if req.admitted_at_tick >= 0 and req.finished_at_tick >= 0 \
            else 0
        return usage

    def _finalize(self, work: _Work):
        req = work.request
        if req.error_code == "ENGINE_FAULT" and self._should_retry(work):
            # zero tokens delivered: the fault is invisible to the client,
            # so requeue with backoff instead of answering 500
            self._schedule_retry(work)
            return
        if req.error_code == "CANCELLED":
            # user cancel / client disconnect: a first-class outcome, not
            # an error; partial output is dropped, the slot already freed
            env = {"status": "cancelled", "code": "CANCELLED",
                   "error": req.error, "model_id": self.model_id}
        elif req.error_code is not None:
            env = self._error_envelope(req.error, req.error_code)
        else:
            try:
                preds = self.wrapper.format_generation(req.output,
                                                       len(work.prompt))
                env = {"status": "ok", "predictions": preds,
                       "model_id": self.model_id,
                       "latency_ms": round(
                           (_mono() - work.t0) * 1e3, 3)}
                self.metrics.inc("max_generated_tokens_total",
                                 len(req.output), model=self.model_id)
            except MAXError as e:
                env = self._error_envelope(str(e))
        work.envelope = env
        if req.error_code == "CANCELLED":
            self.batch_stats.cancelled += 1
        elif req.error_code not in ("DEADLINE_EXCEEDED", "ENGINE_FAULT"):
            # shed work never ran and faulted work never finished: each
            # has its own scheduler count, not 'completed'
            self.batch_stats.completed += 1
        self._count_request(req.priority, env)
        usage = self._usage(work)
        self._observe_phases(req.priority, usage)
        if work.job is not None:
            self._finish_job(work.job, env, usage=usage)
        work.event.set()
        if work.notify is not None:
            try:
                work.notify(env, usage)
            except Exception:       # a broken subscriber must not fail
                pass                # the worker

    def _reap(self):
        """Finalize done requests; flip jobs of admitted work to running."""
        with self._cv:
            done = [self._inflight.pop(rid)
                    for rid in [rid for rid, w in self._inflight.items()
                                if w.request.done]]
            for w in self._inflight.values():
                if (w.job is not None and w.job.state == "queued"
                        and w.request.admitted_at_tick >= 0):
                    w.job.state = "running"
        for work in done:
            self._finalize(work)

    def _fail_all(self, msg: str, code: str = "INTERNAL"):
        with self._cv:
            works = list(self._inflight.values())
            self._inflight.clear()
            works += [w for _, w in self._retry_q]   # parked for backoff
            self._retry_q.clear()
        for work in works:
            work.envelope = self._error_envelope(msg, code)
            if work.job is not None:
                self._finish_job(work.job, work.envelope)
            work.event.set()
            if work.notify is not None:          # release stream consumers
                try:
                    work.notify(work.envelope, None)
                except Exception:
                    pass

    # -- retry with backoff ------------------------------------------------

    def _queue_frac(self) -> float:
        """Queue pressure as a fraction of the per-class admission bound
        (the brownout controller's primary signal)."""
        return self.scheduler.queued_count() / max(1, self.max_queue)

    def _should_retry(self, work: _Work) -> bool:
        """A faulted request may requeue only while the fault is invisible
        (zero delivered tokens), attempts remain, its deadline has not
        passed and the service is open."""
        if self._closed or work.delivered:
            return False
        if work.attempts >= self.max_retries:
            return False
        if work.deadline_at is not None and _mono() >= work.deadline_at:
            return False
        return True

    def _schedule_retry(self, work: _Work, *, locked: bool = False):
        """Park ``work`` for resubmission after an exponential backoff;
        the worker's wait wakes at the earliest due time."""
        work.attempts += 1
        due = _mono() + self.retry_backoff_s * (2 ** (work.attempts - 1))
        self.retries += 1
        self.metrics.inc("max_retries_total", model=self.model_id)
        if work.request is not None and work.request.trace is not None:
            work.request.trace.event("retry", attempt=work.attempts)

        def park():
            self._retry_q.append((due, work))
            self._retry_q.sort(key=lambda t: t[0])
            self._cv.notify_all()
        if locked:
            park()
        else:
            with self._cv:
                park()

    def _retry_wait_locked(self) -> Optional[float]:
        """How long the idle worker may sleep (None: until notified)."""
        if not self._retry_q:
            return None
        return max(0.001, self._retry_q[0][0] - _mono())

    def _drain_due_retries_locked(self) -> List[_Work]:
        """Resubmit every due retry (``_cv`` held). Returns the works
        whose resubmission failed terminally, for the caller to finalize
        outside the lock."""
        failed: List[_Work] = []
        now = _mono()
        while self._retry_q and self._retry_q[0][0] <= now:
            work = self._retry_q.pop(0)[1]
            qos = work.qos
            deadline_s = None
            if work.deadline_at is not None:
                deadline_s = max(0.0, work.deadline_at - _mono())
            work.last_tok_t = None
            try:
                work.request = self.scheduler.submit(
                    work.prompt,
                    priority=_qos_field(qos, "priority"),
                    client=_qos_field(qos, "client"),
                    deadline_s=deadline_s,
                    token_sink=work.sink, **work.gen_kw)
            except Exception as e:
                # admission refused the retry (queue full, rate limit):
                # more backoff while attempts last, else the fault stands
                if self._should_retry(work):
                    self._schedule_retry(work, locked=True)
                else:
                    if work.request is not None:
                        work.request.error = (
                            f"{work.request.error}; retry rejected: {e}")
                    failed.append(work)
                continue
            if work.request.trace is not None:
                work.request.trace.event("retry_resubmit",
                                         attempt=work.attempts)
            if work.job is not None and self.tracer is not None:
                work.job.trace_id = work.request.id   # trace follows retry
            self._inflight[work.request.id] = work
        return failed

    # -- supervision -------------------------------------------------------

    def _observe_pressure(self):
        """Feed scheduler-stat deltas to metrics and the brownout
        controller, once per worker iteration (host counters only)."""
        ss = self.scheduler.stats
        df = ss.engine_faults - self._faults_seen
        if df > 0:
            self._faults_seen = ss.engine_faults
            self.metrics.inc("max_engine_faults_total", df,
                             model=self.model_id)
            if self._brownout is not None:
                self._brownout.note("fault", df)
        dp = ss.pool_exhausted - self._pool_exhausted_seen
        if dp > 0:
            self._pool_exhausted_seen = ss.pool_exhausted
            if self._brownout is not None:
                self._brownout.note("pool_exhausted", dp)
        if self._brownout is not None:
            self._brownout.observe(self._queue_frac())

    def _reset_engine(self, what: str) -> bool:
        """Rebuild the engine's mutable state (worker thread only). A
        failure (a sticky device error survives any reset) is recorded and
        holds readiness down; it is never hidden."""
        try:
            self.engine.reset()
        except Exception as e:
            self._worker_error = self._recovery_error = \
                f"{what} recovery failed: {e}"
            return False
        self._recovery_error = None
        self.scheduler.fault_streak = 0
        return True

    def _maybe_rebuild(self):
        if (self.rebuild_after_faults
                and self.scheduler.fault_streak >= self.rebuild_after_faults):
            self._rebuild_engine(
                f"{self.scheduler.fault_streak} consecutive engine faults")

    def _rebuild_engine(self, reason: str):
        """Quarantine every active slot (their requests retry or fail as
        ENGINE_FAULT), rebuild the engine's pool, caches and prefix cache,
        and go on. Queued work never touched the engine and rides
        through."""
        self.scheduler.quarantine_active(f"engine rebuild: {reason}",
                                         site="rebuild")
        if self._reset_engine("rebuild"):
            self.engine_rebuilds += 1
            self.metrics.inc("max_engine_rebuilds_total",
                             model=self.model_id)
        self._reap()                      # requeue or fail the quarantined

    def _watchdog(self):
        """Flags ticks that blow the stall budget and respawns a dead
        worker (an escaped ``WorkerKill``, or any bug the per-batch
        isolation could not catch). Host state only."""
        while True:
            time.sleep(self.watchdog_interval_s)
            if self._closed:
                return
            t0 = self._tick_started
            if (t0 is not None and not self._stall_flagged
                    and _mono() - t0 > self.stall_budget_s):
                self._stall_flagged = True
                self.tick_stalls += 1
                self.metrics.inc("max_tick_stalls_total",
                                 model=self.model_id)
                if self._brownout is not None:
                    self._brownout.note("stall")
            if not self._thread.is_alive() and not self._closed:
                self._respawn_worker()

    def _respawn_worker(self):
        """The worker died mid-tick, so the engine's state is not trusted.
        Start a fresh worker that quarantines the active slots (their
        requests retry or fail; queued work persists) and resets the
        engine before its first tick: the device stays the worker's."""
        self.worker_restarts += 1
        self.metrics.inc("max_worker_restarts_total", model=self.model_id)
        self._tick_started = None
        self._stall_flagged = False
        with self._cv:
            if self._closed:
                return
            self._recovery = "worker died mid-batch"
            self._thread = threading.Thread(
                target=self._worker, daemon=True,
                name=f"batched-{self.model_id}")
            self._thread.start()

    def _recover(self):
        """A respawned worker's first act: drop the dead worker's slots and
        their unread first tokens without reading them, reset the engine,
        and finalize what retired."""
        reason, self._recovery = self._recovery, None
        self.scheduler.quarantine_active(reason, site="worker")
        self._reset_engine("respawn")
        self._reap()

    def _worker(self):
        self.engine.bind_thread()
        if self._recovery is not None:
            self._recover()
        while True:
            with self._cv:
                while (not self.scheduler.has_work() and not self._closed
                       and not (self._retry_q
                                and self._retry_q[0][0] <= _mono())):
                    self._cv.wait(timeout=self._retry_wait_locked())
                failed = [] if self._closed \
                    else self._drain_due_retries_locked()
                # coalescing window: simultaneous arrivals share the first
                # prefill/decode batch
                deadline = _mono() + self.batch_window_s
                while (self.scheduler.queued_count() < self.engine.max_batch
                       and not self._closed):
                    remaining = deadline - _mono()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                closed = self._closed
            for work in failed:
                self._finalize(work)
            if closed:
                break
            try:
                self._run_batch()
            except WorkerKill as e:
                # injected worker death: leave without cleanup, like a
                # crashed thread; the watchdog respawns and the next
                # worker recovers
                self._worker_error = f"worker killed: {e}"
                return
            except Exception as e:              # the worker must survive a
                self._worker_error = str(e)     # bad batch
                self.scheduler.quarantine_active(f"batch failed: {e}")
                self._reap()
        self._fail_all(f"service for {self.model_id!r} is closed")

    def _run_batch(self):
        """Tick the scheduler until it drains, admitting newcomers and due
        retries between ticks (continuous batching); the controller
        decides who gets the next free slot."""
        sched = self.scheduler
        while not self._closed:
            with self._cv:
                failed = self._drain_due_retries_locked()
            for work in failed:
                self._finalize(work)
            if not sched.has_work():
                break
            self._tick_started = _mono()      # the watchdog's stall clock
            sched.tick()
            self._tick_started = None
            self._stall_flagged = False
            self._reap()
            self._observe_pressure()
            self._maybe_rebuild()
        self._reap()

    # -- introspection / lifecycle ----------------------------------------

    def idle(self) -> bool:
        """True when nothing is queued, active or parked for retry."""
        with self._cv:
            return (not self._inflight and not self._retry_q
                    and not self.scheduler.has_work())

    def health(self) -> Dict[str, Any]:
        """Liveness/readiness/degradation for ``GET /v2/health``: live
        while open; ready with a live worker, the circuit closed and no
        failed recovery. ``draining`` is the fleet's (always False
        here)."""
        alive = self._thread.is_alive()
        state = "normal"
        if self._brownout is not None:
            state = self._brownout.observe(self._queue_frac())
        return {
            "live": not self._closed,
            "ready": (not self._closed and alive and state != "hard"
                      and self._recovery_error is None),
            "draining": False,
            "degradation": state,
            "worker_alive": alive,
            "worker_restarts": self.worker_restarts,
            "tick_stalls": self.tick_stalls,
            "engine_faults": self.scheduler.stats.engine_faults,
            "engine_rebuilds": self.engine_rebuilds,
            "retry_pending": len(self._retry_q),
            "queue_depth": self.scheduler.queued_count(),
        }

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        bs, ss = self.batch_stats, self.scheduler.stats
        out.update({
            "submitted": bs.submitted,
            "completed": bs.completed,
            "rejected": bs.rejected,
            # every CANCELLED retire (jobs, streams, disconnects): a
            # superset of the base class's job-only count
            "cancelled": bs.cancelled,
            "shed": ss.shed,
            "engine_faults": ss.engine_faults,
            "decode_steps": ss.decode_steps,
            "decode_chunks": ss.chunks,
            "decode_chunk": self.scheduler.decode_chunk,
            "prefills": ss.prefills,
            "cache_overflows": ss.cache_overflows,
            "pool_exhausted": ss.pool_exhausted,
            "kv_cache": self.engine.kv_stats(),
            "emitted_tokens": ss.emitted_tokens,
            "tokens_per_s": round(ss.tokens_per_s, 2),
            "mean_batch_size": round(ss.mean_batch_size, 3),
            "max_batch_seen": ss.max_occupancy,
            "batch_window_s": self.batch_window_s,
            "queue_depth": self.scheduler.queued_count(),
            "engine_max_batch": self.engine.max_batch,
        })
        if self.engine.prefix_cache is not None:
            # also nested under kv_cache; top-level so dashboards need not
            # know the KV layout to find hit rates
            out["prefix_cache"] = self.engine.prefix_stats()
        out["robustness"] = {
            "engine_faults": ss.engine_faults,
            "retries": self.retries,
            "retry_pending": len(self._retry_q),
            "worker_restarts": self.worker_restarts,
            "engine_rebuilds": self.engine_rebuilds,
            "tick_stalls": self.tick_stalls,
            "worker_alive": self._thread.is_alive(),
            "brownout": (self._brownout.stats() if self._brownout is not None
                         else {"state": "normal"}),
            "fault_injection": (self.fault_plane.stats()
                                if self.fault_plane is not None else None),
        }
        if self._worker_error:
            out["last_worker_error"] = self._worker_error
        return out

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        # the worker exits at its next wait/tick boundary and fails what it
        # still holds; the direct _fail_all covers a worker stuck past the
        # join timeout (each work is popped once under the lock)
        self._thread.join(timeout=30)
        self._watchdog_thread.join(timeout=2 * self.watchdog_interval_s + 1)
        self._fail_all(f"service for {self.model_id!r} is closed")
        super().close()


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def make_service(wrapper: MAXModelWrapper, mode: str = "auto",
                 **service_kw) -> InferenceService:
    """``mode``: 'sync' | 'batched' | 'auto' (batched iff the wrapper speaks
    the generation protocol). ``qos`` / ``metrics`` / ``job_ttl_s`` and the
    tracing knobs (``trace`` / ``trace_buffer`` / ``slow_trace_ms``) apply
    to either kind; the remaining kwargs, the robustness knobs (``faults``,
    ``brownout``, ``max_retries``, ``stall_budget_s``, ...) included, are
    batched-service tuning and are ignored by sync services (a sync call
    has no worker to supervise or queue to shed)."""
    shared = {k: service_kw.pop(k)
              for k in ("qos", "metrics", "job_ttl_s",
                        "trace", "trace_buffer", "slow_trace_ms")
              if k in service_kw}
    if mode == "sync":
        return SyncService(wrapper, **shared)
    if mode == "batched":
        return BatchedService(wrapper, **service_kw, **shared)
    if mode == "auto":
        if wrapper.supports_generation():
            return BatchedService(wrapper, **service_kw, **shared)
        return SyncService(wrapper, **shared)
    raise ValueError(f"unknown service mode {mode!r} "
                     "(expected sync|batched|auto)")
