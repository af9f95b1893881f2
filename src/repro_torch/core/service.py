"""Inference services — the execution strategy behind a deployment
(counterpart of ``repro/core/service.py``).

- :class:`InferenceService`  the uniform predict / predict_batch / stats
                             surface over one wrapped model.
- :class:`BatchedService`    owns a :class:`ContinuousBatchingScheduler` on
                             a background worker thread; concurrent
                             requests land in its FIFO queue, a short
                             *batching window* lets simultaneous arrivals
                             coalesce, and the engine decodes them as ONE
                             batch.

The envelopes are the JAX package's (``{"status": "ok", "predictions":
..., "model_id": ..., "latency_ms": ...}`` or a structured error), so a
caller cannot tell the two packages apart.

Not ported yet: ``SyncService``, jobs, SSE streams, QoS admission,
metrics, tracing, retry, the watchdog and brownout.
"""

from __future__ import annotations

import abc
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.wrapper import MAXError, MAXModelWrapper, PromptTooLong
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.serving.tracing import now as _mono


class ServiceOverloaded(MAXError):
    """Bounded request queue is full — client should back off (HTTP 429)."""


class InferenceService(abc.ABC):
    """Uniform predict/predict_batch surface over one wrapped model."""

    kind: str = "abstract"

    def __init__(self, wrapper: MAXModelWrapper):
        self.wrapper = wrapper

    @property
    def model_id(self) -> str:
        return self.wrapper.metadata.id

    @abc.abstractmethod
    def predict(self, inp: Any) -> Dict[str, Any]:
        """Return the standardized envelope for one input."""

    def predict_batch(self, inputs: List[Any]) -> List[Dict[str, Any]]:
        """Per-input envelopes for an explicit multi-input request."""
        return [self.predict(i) for i in inputs]

    def stats(self) -> Dict[str, Any]:
        return {"kind": self.kind}

    def close(self):
        pass


@dataclass
class _Work:
    """One logical generation riding the scheduler."""
    prompt: List[int]
    gen_kw: Dict[str, Any]
    t0: float
    event: threading.Event = field(default_factory=threading.Event)
    request: Optional[Any] = None     # scheduler Request
    envelope: Optional[Dict[str, Any]] = None


@dataclass
class BatchStats:
    """Service-level counters; batch sizes live on the scheduler's stats."""
    submitted: int = 0
    completed: int = 0
    rejected: int = 0                 # queue full at submit
    cancelled: int = 0


class BatchedService(InferenceService):
    """Aggregates concurrent requests into engine decode batches.

    A single worker thread owns the scheduler (and so the engine cache);
    request threads submit and wait on a per-request event, so no engine
    state is touched concurrently. ``batch_window_s`` is the coalescing
    window: when the engine is idle and a request arrives, the worker waits
    that long (or until the batch is full) for simultaneous arrivals
    before the first prefill, then keeps admitting newcomers every tick.
    ``decode_chunk`` is the fused-decode granularity (one host sync per
    chunk)."""

    kind = "batched"

    def __init__(self, wrapper: MAXModelWrapper, *,
                 batch_window_s: float = 0.01, max_queue: int = 64,
                 request_timeout_s: float = 300.0,
                 decode_chunk: Optional[int] = None, seed: int = 0):
        if not wrapper.supports_generation():
            raise ValueError(
                f"{wrapper.metadata.id!r} does not implement the generation "
                "protocol (prepare_generation/format_generation)")
        super().__init__(wrapper)
        self.engine = wrapper.engine
        self.scheduler = ContinuousBatchingScheduler(
            self.engine, decode_chunk=decode_chunk, seed=seed)
        self.batch_window_s = batch_window_s
        self.max_queue = max_queue
        self.request_timeout_s = request_timeout_s
        self.batch_stats = BatchStats()
        self._ttft_s: deque = deque(maxlen=1024)   # recent, for stats()
        self._inflight: Dict[int, _Work] = {}
        self._cv = threading.Condition()
        self._closed = False
        self._worker_error: Optional[str] = None
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name=f"batched-{self.model_id}")
        self._thread.start()

    # -- request path ------------------------------------------------------

    def _enqueue(self, inp: Any) -> _Work:
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
        work = _Work(prompt=prompt, gen_kw=gen_kw, t0=_mono())
        with self._cv:
            if self._closed:
                raise MAXError(f"service for {self.model_id!r} is closed")
            if self.scheduler.queued_count() >= self.max_queue:
                self.batch_stats.rejected += 1
                raise ServiceOverloaded(
                    f"queue for {self.model_id!r} is full "
                    f"({self.max_queue} waiting)")
            work.request = self.scheduler.submit(prompt, **gen_kw)
            self._inflight[work.request.id] = work
            self.batch_stats.submitted += 1
            self._cv.notify_all()
        return work

    def _error_envelope(self, msg: str, code: str = "INVALID_INPUT"
                        ) -> Dict[str, Any]:
        # "code" is consumed by the API layer (v2 maps it to a structured
        # error and an HTTP status)
        return {"status": "error", "error": msg, "code": code,
                "model_id": self.model_id}

    def _enqueue_or_error(self, inp: Any):
        try:
            return self._enqueue(inp)
        except ServiceOverloaded as e:
            return self._error_envelope(str(e), "QUEUE_FULL")
        except PromptTooLong as e:
            return self._error_envelope(str(e), "PROMPT_TOO_LONG")
        except MAXError as e:
            return self._error_envelope(str(e))

    def _await(self, work) -> Dict[str, Any]:
        if isinstance(work, dict):              # rejected at enqueue
            return work
        if not work.event.wait(self.request_timeout_s):
            return self._error_envelope(
                f"timed out after {self.request_timeout_s}s", "TIMEOUT")
        return work.envelope

    def predict(self, inp: Any) -> Dict[str, Any]:
        return self._await(self._enqueue_or_error(inp))

    def predict_batch(self, inputs: List[Any]) -> List[Dict[str, Any]]:
        # enqueue all first so they share decode batches, then wait all
        return [self._await(w)
                for w in [self._enqueue_or_error(i) for i in inputs]]

    # -- worker ------------------------------------------------------------

    def _finalize(self, work: _Work):
        req = work.request
        if req.error_code == "CANCELLED":
            env = {"status": "cancelled", "code": "CANCELLED",
                   "error": req.error, "model_id": self.model_id}
            self.batch_stats.cancelled += 1
        elif req.error_code is not None:
            env = self._error_envelope(req.error, req.error_code)
        else:
            try:
                preds = self.wrapper.format_generation(req.output,
                                                       len(work.prompt))
                env = {"status": "ok", "predictions": preds,
                       "model_id": self.model_id,
                       "latency_ms": round((_mono() - work.t0) * 1e3, 3)}
            except MAXError as e:
                env = self._error_envelope(str(e))
        if req.error_code not in ("CANCELLED", "ENGINE_FAULT"):
            self.batch_stats.completed += 1
        if req.first_token_s is not None:
            self._ttft_s.append(req.first_token_s - work.t0)
        work.envelope = env
        work.event.set()

    def _reap(self):
        """Finalize done requests."""
        with self._cv:
            done = [self._inflight.pop(rid)
                    for rid in [rid for rid, w in self._inflight.items()
                                if w.request.done]]
        for work in done:
            self._finalize(work)

    def _fail_all(self, msg: str, code: str = "INTERNAL"):
        with self._cv:
            works = list(self._inflight.values())
            self._inflight.clear()
        for work in works:
            work.envelope = self._error_envelope(msg, code)
            work.event.set()

    def _worker(self):
        while True:
            with self._cv:
                while not self.scheduler.has_work() and not self._closed:
                    self._cv.wait()
                if self._closed:
                    break
                # coalescing window: simultaneous arrivals share the first
                # prefill/decode batch
                deadline = _mono() + self.batch_window_s
                while (self.scheduler.queued_count() < self.engine.max_batch
                       and not self._closed):
                    remaining = deadline - _mono()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                if self._closed:
                    break
            try:
                self._run_batch()
            except Exception as e:              # the worker must survive a
                self._worker_error = str(e)     # bad batch
                self.scheduler.quarantine_active(f"batch failed: {e}")
                self._reap()
        self._fail_all(f"service for {self.model_id!r} is closed")

    def _run_batch(self):
        """Tick the scheduler until it drains, admitting newcomers between
        ticks (continuous batching)."""
        while not self._closed and self.scheduler.has_work():
            self.scheduler.tick()
            self._reap()
        self._reap()

    # -- introspection / lifecycle ----------------------------------------

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        bs, ss = self.batch_stats, self.scheduler.stats
        ttft = sorted(self._ttft_s)
        out.update({
            "submitted": bs.submitted,
            "completed": bs.completed,
            "rejected": bs.rejected,
            "cancelled": bs.cancelled,
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
            "ttft": {"count": len(ttft),
                     "p50_ms": (round(ttft[len(ttft) // 2] * 1e3, 3)
                                if ttft else None),
                     "max_ms": round(ttft[-1] * 1e3, 3) if ttft else None},
        })
        if self.engine.prefix_cache is not None:
            # also nested under kv_cache; top-level so dashboards need not
            # know the KV layout to find hit rates
            out["prefix_cache"] = self.engine.prefix_stats()
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
        self._fail_all(f"service for {self.model_id!r} is closed")


def make_service(wrapper: MAXModelWrapper, mode: str = "auto",
                 **service_kw) -> InferenceService:
    """``mode``: 'batched' | 'auto' (batched for wrappers that speak the
    generation protocol). 'sync' is not ported yet."""
    if mode not in ("sync", "batched", "auto"):
        raise ValueError(f"unknown service mode {mode!r} "
                         "(expected sync|batched|auto)")
    if mode == "sync" or not wrapper.supports_generation():
        raise NotImplementedError(
            "SyncService is not ported yet; the PyTorch port serves "
            "generation wrappers through BatchedService")
    return BatchedService(wrapper, **service_kw)
