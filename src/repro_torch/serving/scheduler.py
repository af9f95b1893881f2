"""Continuous batching scheduler (counterpart of
``repro/serving/scheduler.py``).

Drives a :class:`GenerationEngine`'s slot API: admits queued requests into
free decode slots as soon as they open (prefill on admit), runs one fused
decode chunk for all active slots per tick, retires finished requests at
chunk boundaries and backfills at once.

Exactly one host read per tick: the first tokens of this tick's
admissions and the chunk's token block travel to the host in a single
transfer, and every token sink, stat and trace stamp of the tick is fed
from that host copy (no per-request or per-token read). The chunk length
is budget-aligned: the largest power of two not above ``decode_chunk`` or
the earliest remaining budget, so a chunk never runs past the first
completion and the engine sees a bounded set of lengths.

Sampling noise comes from a ``torch.Generator`` on the engine's device,
seeded from ``seed`` (the JAX scheduler splits a ``jax.random`` key).

Admission order is pluggable: a FIFO deque (arrival order) by default, or
an :class:`~repro_torch.serving.qos.AdmissionController` (priority
classes, per-client fairness, deadline shedding) when one is passed. Shed
requests retire with ``DEADLINE_EXCEEDED`` without touching a slot; the
admission cost is ``QoSConfig.request_cost(max_new_tokens)``.

Streaming and cancellation ride the chunk boundaries: a :class:`Request`
may carry a ``token_sink`` fed with exactly the tokens the tick's host
read revealed, ``first_token_s`` is stamped there, and ``cancel`` drops
queued work from admission (never touching a slot) or frees a running
slot at the next chunk boundary (freed slots backfill in the same tick;
cancelled requests retire with ``CANCELLED``).

Admission is block-gated on paged engines: a request is placed only when
the shared KV page pool can hold its prefill (``engine.can_admit``, which
on a prefix-cached engine charges only the pages the cache cannot seat).
The FIFO path holds its head in line; the QoS path parks granted requests
in a deferred queue that keeps first claim, in grant order, on freed
pages. Before each chunk the scheduler secures a page per upcoming KV
write (``ensure_capacity``); a slot that cannot take one more write
retires with ``KV_POOL_EXHAUSTED`` instead of stalling the co-batch, and a
prompt that needs more pages than the pool holds retires without touching
a slot.

An optional :class:`~repro_torch.serving.tracing.Tracer` records spans at
these same points (submit, QoS enqueue/grant/shed, deferred park/unpark,
admission, first token, each chunk, stall, cancel, retire); with
``tracer=None`` each hook is one attribute check.

Fault boundary: the two places a tick touches the engine, prefill
admission and the fused chunk dispatch and read, are supervised. An
exception there retires only the implicated slots as ``ENGINE_FAULT``
(an injected fault names its victim; a real exception implicates the
whole co-batch, whose device state is no longer trusted) and never
unwinds the worker. Sinks and ``req.output`` are fed only from the
tick's read, so a faulted chunk delivers no token. An optional
:class:`~repro_torch.serving.faults.FaultPlane` (``faults=``) injects
deterministic faults at exactly these boundaries; with ``faults=None``
each hook is one ``is not None`` check and the tick keeps its one host
read. ``fault_streak`` counts consecutive faults with no clean chunk in
between (the supervising service's rebuild trigger).

Thread-safety: ``submit``, ``cancel`` and ``poll`` are lock-free (a
deque append, a dict lookup and a flag store are atomic, and the
controller has its own lock), so request threads never queue behind a
decode chunk; only ``tick`` takes the scheduler lock.
Engine state is only touched from inside ``tick``, by whichever single
thread drives the loop.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.faults import FaultPlane, InjectedFault
from repro_torch.serving.tracing import now as _now


# eq=False: requests compare by identity, which keeps deque.remove() a
# C-level scan (submit appends lock-free while a sweep removes)
@dataclass(eq=False)
class Request:
    id: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    # QoS identity (set when submitted through an AdmissionController)
    priority: str = "batch"
    client: str = "anon"
    # called at the tick's host read with the tokens it revealed for this
    # request (Python ints); runs on the worker thread under the scheduler
    # lock, so it must be O(1) and non-blocking; exceptions are swallowed
    token_sink: Optional[Any] = None
    # absolute start-by deadline on the serving clock (the controller
    # enforces it while queued; this copy covers the deferred wait)
    deadline_at: Optional[float] = None
    # filled by the scheduler
    output: List[int] = field(default_factory=list)
    slot: int = -1
    admitted_at_tick: int = -1
    finished_at_tick: int = -1
    # lifecycle stamps on the serving clock (tracing.now)
    submitted_at_s: float = 0.0
    admitted_at_s: Optional[float] = None
    finished_at_s: Optional[float] = None
    first_token_s: Optional[float] = None
    trace: Optional[Any] = field(default=None, repr=False)  # RequestTrace
    cancelled: bool = False
    error: Optional[str] = None
    error_code: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.finished_at_tick >= 0


@dataclass
class SchedulerStats:
    ticks: int = 0
    decode_steps: int = 0             # engine decode steps (chunk = K steps)
    chunks: int = 0                   # fused chunk dispatches (sync points)
    prefills: int = 0
    emitted_tokens: int = 0
    completed: int = 0
    shed: int = 0                     # deadline-expired, never ran
    cancelled: int = 0
    cache_overflows: int = 0          # retired with MAX_SEQ_EXCEEDED
    pool_exhausted: int = 0           # retired with KV_POOL_EXHAUSTED
    rejected: int = 0                 # retired with PROMPT_TOO_LONG
    engine_faults: int = 0            # retired with ENGINE_FAULT
    wall_s: float = 0.0               # accrued per tick
    occupancy_sum: int = 0            # sum of active-batch sizes per step
    max_occupancy: int = 0
    host_reads: int = 0               # device -> host transfers (<= ticks)

    @property
    def tokens_per_s(self) -> float:
        return self.emitted_tokens / self.wall_s if self.wall_s else 0.0

    @property
    def mean_batch_size(self) -> float:
        return self.occupancy_sum / self.decode_steps \
            if self.decode_steps else 0.0


class ContinuousBatchingScheduler:
    def __init__(self, engine: GenerationEngine, *, seed: int = 0,
                 retain_completed: int = 1024, admission=None,
                 decode_chunk: Optional[int] = None, tracer=None,
                 faults=None):
        self.engine = engine
        # Optional fault-injection plane (FaultPlane | FaultSpec | dict);
        # None keeps every hook a bare attribute check
        if faults is not None and not isinstance(faults, FaultPlane):
            faults = FaultPlane(faults)
        self.faults = faults
        # consecutive engine faults with no committed chunk in between
        self.fault_streak = 0
        # Optional[Tracer]: spans at the existing sync points; every hook
        # is guarded, so tracer=None costs one attribute check
        self.tracer = tracer
        # scheduler-local override, floored to a power of two like the
        # engine default
        self._decode_chunk = 1 << (max(1, int(decode_chunk)).bit_length() - 1) \
            if decode_chunk is not None else None
        self.admission = admission        # Optional[AdmissionController]
        self.queue: deque[Request] = deque()      # FIFO path (admission=None)
        # QoS-granted work waiting for KV pool pages or a slot: the
        # controller already dequeued it, so it keeps first claim, in its
        # grant order, on what retiring slots free
        self._deferred: deque[Request] = deque()
        self.active: Dict[int, Request] = {}      # slot -> request
        self._temps = np.zeros((engine.max_batch,), np.float32)
        # requests placed this tick whose on-device first token has not
        # been read yet (read with the chunk at the tick's sync point)
        self._pending_first: List[Tuple[Request, torch.Tensor]] = []
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)
        self._ids = itertools.count()
        self._lock = threading.RLock()
        self.retain_completed = retain_completed
        self._completed: Dict[int, Request] = {}
        self._pending: Dict[int, Request] = {}   # queued or active, by id
        self.stats = SchedulerStats()

    @property
    def decode_chunk(self) -> int:
        return self._decode_chunk if self._decode_chunk is not None \
            else self.engine.decode_chunk

    def submit(self, prompt: List[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, priority: Optional[str] = None,
               client: Optional[str] = None,
               deadline_s: Optional[float] = None,
               token_sink: Optional[Any] = None) -> Request:
        """Enqueue a request (lock-free; see the module docstring). With
        an admission controller attached this may raise an
        :class:`~repro_torch.serving.qos.AdmissionError` on the submitting
        thread. ``token_sink`` is installed before the request becomes
        visible to the decode loop, so a streaming caller misses no
        token."""
        t_sub = _now()
        req = Request(next(self._ids), list(prompt), max_new_tokens,
                      temperature, token_sink=token_sink,
                      submitted_at_s=t_sub,
                      deadline_at=(t_sub + deadline_s
                                   if deadline_s is not None else None))
        if self.tracer is not None:
            req.trace = self.tracer.start(
                req.id, prompt_tokens=len(req.prompt),
                max_new_tokens=max_new_tokens, submitted_at=t_sub)
        self._pending[req.id] = req
        if self.admission is not None:
            try:
                ticket = self.admission.submit(
                    req, priority=priority, client=client,
                    cost=self.admission.cfg.request_cost(max_new_tokens),
                    deadline_s=deadline_s)
            except Exception as e:
                self._pending.pop(req.id, None)   # rejected: nothing to cancel
                if req.trace is not None:         # a rejection is a
                    code = getattr(e, "code", "REJECTED")   # complete trace
                    self.tracer.finish(req.trace, outcome=code,
                                       error_code=code)
                raise
            req.priority, req.client = ticket.priority, ticket.client
            if req.trace is not None:
                req.trace.priority, req.trace.client = \
                    ticket.priority, ticket.client
                req.trace.event("qos_enqueue", **{
                    "class": ticket.priority, "client": ticket.client,
                    "cost": ticket.cost})
        else:
            if req.trace is not None:
                req.trace.priority, req.trace.client = \
                    req.priority, req.client
            self.queue.append(req)
        return req

    def cancel(self, request_id: int) -> bool:
        """Mark a queued or running request cancelled; the decode loop
        honours the mark at its next tick (a queued request never touches
        a slot, a running one frees its slot at the next chunk boundary).
        False when unknown or done (the cancel raced completion).
        Lock-free, so it never waits out a chunk."""
        req = self._pending.get(request_id)
        if req is None or req.done:
            return False
        req.cancelled = True
        return not req.done

    def poll(self, request_id: int) -> Optional[Request]:
        """Completed request by id, else None (still queued/active)."""
        return self._completed.get(request_id)

    def queued_count(self) -> int:
        # lock-free point-in-time reads: they must not wait on a chunk
        if self.admission is not None:
            return self.admission.depth() + len(self._deferred)
        return len(self.queue)

    def has_work(self) -> bool:
        if self.admission is not None:
            return bool(self.admission.depth() or self._deferred
                        or self.active)
        return bool(self.queue or self.active)

    def active_count(self) -> int:
        return len(self.active)

    # -- retire paths ----------------------------------------------------------

    def _retire(self, req: Request):
        req.finished_at_tick = self.stats.ticks
        req.finished_at_s = _now()
        self._pending.pop(req.id, None)
        self._completed[req.id] = req
        while len(self._completed) > self.retain_completed:
            self._completed.pop(next(iter(self._completed)))
        if req.trace is not None:
            # every retire path ends here, so cancelled, shed and
            # exhausted requests get complete traces too
            self.tracer.finish(req.trace,
                               outcome=req.error_code or "ok",
                               error_code=req.error_code,
                               tick=self.stats.ticks,
                               completion_tokens=len(req.output),
                               ts=req.finished_at_s)

    def _release(self, req: Request):
        # tokens as fed (prompt + generated) let a prefix-cached engine
        # register the slot's fully written pages before they free
        self.engine.release_slot(req.slot, tokens=req.prompt + req.output)
        del self.active[req.slot]
        self._retire(req)

    def _shed(self, req: Request):
        if req.cancelled:             # cancelled while queued: its own code
            self._cancel_retire(req)
            return
        req.error = ("deadline exceeded while queued "
                     f"(waited for a decode slot, class {req.priority!r})")
        req.error_code = "DEADLINE_EXCEEDED"
        if req.trace is not None:
            req.trace.event("qos_shed", **{"class": req.priority,
                                           "client": req.client})
        self._retire(req)
        self.stats.shed += 1

    def _cancel_retire(self, req: Request):
        """Retire a cancelled request (queued: never ran; active: the
        caller releases the slot first). Partial output stays on it."""
        req.error = (f"cancelled after {len(req.output)} generated tokens"
                     if req.output else "cancelled before starting")
        req.error_code = "CANCELLED"
        if req.trace is not None:
            req.trace.event("cancel", ran=req.slot >= 0,
                            generated=len(req.output))
        self._retire(req)
        self.stats.cancelled += 1

    def _too_long(self, req: Request):
        req.error = (f"prompt of {len(req.prompt)} tokens leaves no "
                     f"generation headroom (max_seq {self.engine.max_seq}, "
                     f"max admissible {self.engine.max_prompt_len()})")
        req.error_code = "PROMPT_TOO_LONG"
        self._retire(req)
        self.stats.rejected += 1

    def _pool_exhausted(self, req: Request):
        """The shared KV pool cannot give the slot its next page: retire
        cleanly (partial output stays on the request) rather than stall
        the co-batch behind an unpageable slot."""
        req.error = (f"KV pool exhausted after {len(req.output)} generated "
                     f"tokens (requested {req.max_new_tokens}; pool = "
                     f"{self.engine.kv_pool_blocks} pages of "
                     f"{self.engine.page_size} tokens)")
        req.error_code = "KV_POOL_EXHAUSTED"
        if req.trace is not None:
            req.trace.event("stall", kind="KV_POOL_EXHAUSTED",
                            generated=len(req.output))
        self._release(req)
        self.stats.completed += 1
        self.stats.pool_exhausted += 1

    def _never_admissible(self, req: Request) -> bool:
        """True for requests no amount of waiting can place: no generation
        headroom, or more prefill pages than the whole pool holds."""
        if not self.engine.fits_prompt(len(req.prompt)):
            return True
        return (self.engine.paged
                and self.engine.blocks_for_prompt(len(req.prompt))
                > self.engine.kv_pool_blocks)

    def _retire_inadmissible(self, req: Request):
        if not self.engine.fits_prompt(len(req.prompt)):
            self._too_long(req)
            return
        req.error = (f"prompt of {len(req.prompt)} tokens needs more "
                     f"KV pool pages than the pool holds "
                     f"({self.engine.kv_pool_blocks} pages of "
                     f"{self.engine.page_size} tokens)")
        req.error_code = "KV_POOL_EXHAUSTED"
        self._retire(req)
        self.stats.pool_exhausted += 1

    def _overflow(self, req: Request):
        """Cache full before the request finished: retire cleanly (the
        engine's termination mask already froze the slot)."""
        req.error = (f"sequence reached max_seq {self.engine.max_seq} after "
                     f"{len(req.output)} generated tokens "
                     f"(requested {req.max_new_tokens})")
        req.error_code = "MAX_SEQ_EXCEEDED"
        self._release(req)
        self.stats.completed += 1
        self.stats.cache_overflows += 1

    def _engine_fault_retire(self, req: Request, msg: str, site: str):
        req.error = f"engine fault during {site}: {msg}"
        req.error_code = "ENGINE_FAULT"
        if req.trace is not None:
            req.trace.event("fault", site=site, generated=len(req.output))
        self._retire(req)
        self.stats.engine_faults += 1
        self.fault_streak += 1

    def _quarantine_slot(self, slot: int, msg: str, site: str):
        """Evict one active slot after a fault and drop its unread first
        token. The release passes no tokens (a faulted slot's KV must not
        reach the prefix cache) and is defensive: the fault may have left
        the device unusable."""
        req = self.active.pop(slot, None)
        if req is None:
            return
        try:
            self.engine.release_slot(slot)
        except Exception:
            pass
        self._pending_first = [(r, f) for (r, f) in self._pending_first
                               if r is not req]
        self._engine_fault_retire(req, msg, site)

    def quarantine_active(self, reason: str, *, site: str = "engine"):
        """Retire every active slot as ENGINE_FAULT and drop unread first
        tokens without reading them: after a real dispatch or read fault,
        a dead worker or an engine rebuild, the batch's device state is no
        longer trusted. Queued work is untouched."""
        with self._lock:
            for slot in sorted(self.active):
                self._quarantine_slot(slot, reason, site)
            self._pending_first.clear()

    def _maybe_finish(self, req: Request):
        eos = self.engine.eos_id
        if (len(req.output) >= req.max_new_tokens
                or (eos is not None and req.output and req.output[-1] == eos)):
            self._release(req)
            self.stats.completed += 1

    # -- scheduling ----------------------------------------------------------

    @staticmethod
    def _sweep_queue(q: "deque[Request]") -> List[Request]:
        """Remove cancelled entries from ``q`` in place and return them
        (per-item ``remove``: a concurrent lock-free append keeps its
        place)."""
        swept = []
        for req in [r for r in list(q) if r.cancelled]:
            try:
                q.remove(req)
            except (ValueError, IndexError, RuntimeError):
                continue
            swept.append(req)
        return swept

    def _sweep_cancelled(self):
        """Honour cancellation marks before admission, so a slot freed by a
        running cancel backfills this very tick. FIFO and deferred work is
        swept in place (the controller sweeps its own in ``take``), and a
        deferred request's deadline keeps running while it waits."""
        for req in [r for r in self.active.values() if r.cancelled]:
            self.engine.release_slot(req.slot,
                                     tokens=req.prompt + req.output)
            del self.active[req.slot]
            self._cancel_retire(req)
        if self.admission is None:
            for req in self._sweep_queue(self.queue):
                self._cancel_retire(req)
        for req in self._sweep_queue(self._deferred):
            self._cancel_retire(req)
        now = _now()
        for req in [r for r in list(self._deferred)
                    if r.deadline_at is not None and r.deadline_at < now]:
            try:
                self._deferred.remove(req)
            except (ValueError, IndexError, RuntimeError):
                continue
            self._shed(req)

    def _place(self, req: Request, slot: int) -> bool:
        """Dispatch prefill + on-device first token; no host sync here.
        False when the admission faulted: the request retires as
        ENGINE_FAULT and the slot stays free."""
        req.admitted_at_s = _now()
        try:
            if self.faults is not None:
                self.faults.check_admission(self.stats.ticks)
            first = self.engine.insert_request(req.prompt, slot)
        except Exception as e:     # the engine released the slot already
            self._engine_fault_retire(req, str(e), "admission")
            return False
        req.slot = slot
        req.admitted_at_tick = self.stats.ticks
        self._temps[slot] = req.temperature
        self.active[slot] = req
        self._pending_first.append((req, first))
        self.stats.prefills += 1
        if req.trace is not None:
            # the engine's host-side admission summary (prefix-cache hit
            # tokens vs cold prefill, pages, COW)
            req.trace.admitted(req.admitted_at_s, slot=slot,
                               tick=self.stats.ticks,
                               admission=self.engine.last_admission)
        return True

    def _admit(self):
        """Admission is gated on free slots and, on paged engines, on
        claimable pool pages (the token list: a prefix-cached engine
        charges only the pages its cache cannot seat). FIFO holds its head
        in line while pages are short; under QoS, granted work that cannot
        be seated waits in ``_deferred`` ahead of new grants."""
        free = self.engine.free_slots()
        blocked = False
        while free and self._deferred:
            req = self._deferred[0]
            if req.cancelled:
                self._deferred.popleft()
                self._cancel_retire(req)
                continue
            if not self.engine.can_admit(req.prompt):
                blocked = True            # pool still tight: hold order
                break
            self._deferred.popleft()
            if req.trace is not None:
                req.trace.event("deferred_unpark")
            slot = free.pop(0)
            if not self._place(req, slot):
                free.insert(0, slot)
        if self.admission is not None:
            # the controller decides order; it also sweeps expired and
            # cancelled work when no slot is free (k == 0)
            tickets, shed = self.admission.take(0 if blocked else len(free))
            for t in shed:
                self._shed(t.item)
            for t in tickets:
                if t.item.trace is not None:
                    t.item.trace.event("qos_grant", **{
                        "class": t.priority, "client": t.client})
                if t.item.cancelled:              # raced the sweep
                    self._cancel_retire(t.item)
                    continue
                if self._never_admissible(t.item):
                    self._retire_inadmissible(t.item)
                    continue
                if not free or not self.engine.can_admit(t.item.prompt):
                    if t.item.trace is not None:
                        t.item.trace.event(
                            "deferred_park",
                            reason="no_slot" if not free else "no_blocks")
                    self._deferred.append(t.item)
                    continue
                slot = free.pop(0)
                if not self._place(t.item, slot):
                    free.insert(0, slot)
            return
        while free and self.queue and not blocked:
            req = self.queue[0]
            if req.cancelled:
                self.queue.popleft()
                self._cancel_retire(req)
                continue
            if self._never_admissible(req):
                self.queue.popleft()
                self._retire_inadmissible(req)
                continue
            if not self.engine.can_admit(req.prompt):
                break
            self.queue.popleft()
            slot = free.pop(0)
            if not self._place(req, slot):
                free.insert(0, slot)

    def _secure_pages(self, budgets: np.ndarray):
        """Paged engines: secure a pool page for every KV write of the
        coming chunk before it is dispatched. A slot that cannot take one
        more write retires now (its pages may unblock the slots after
        it); a partly secured slot decodes up to its headroom."""
        for slot, req in list(self.active.items()):
            if budgets[slot] <= 0:
                continue
            got = self.engine.ensure_capacity(
                slot, min(self.decode_chunk, int(budgets[slot])))
            if got == 0:
                if self.engine.context_len(slot) >= self.engine.max_seq:
                    self._overflow(req)
                else:
                    self._pool_exhausted(req)
                budgets[slot] = 0
                continue
            budgets[slot] = min(int(budgets[slot]), got)

    def _read(self, toks, emitted) -> Tuple[List[int], Optional[np.ndarray],
                                            Optional[np.ndarray]]:
        """THE tick's host sync: pending first tokens and the chunk block
        in one device -> host transfer."""
        parts = [f.reshape(1) for _, f in self._pending_first]
        if toks is not None:
            parts += [toks.reshape(-1), emitted.to(torch.int32).reshape(-1)]
        if not parts:
            return [], None, None
        flat = torch.cat(parts).cpu().numpy()
        self.stats.host_reads += 1
        n = len(self._pending_first)
        firsts = [int(x) for x in flat[:n]]
        if toks is None:
            return firsts, None, None
        size = toks.numel()
        return (firsts, flat[n:n + size].reshape(toks.shape),
                flat[n + size:].reshape(toks.shape).astype(bool))

    def _feed_sink(self, req: Request, tokens: List[int]):
        """Per-chunk token delivery and the first-token stamp, from the
        tick's host copy. A sink fault must never poison the tick."""
        if req.first_token_s is None:
            req.first_token_s = _now()
            if req.trace is not None:
                req.trace.first_token(req.first_token_s)
        if req.token_sink is not None:
            try:
                req.token_sink(tokens)
            except Exception:
                pass

    def tick(self):
        """One iteration: admit -> decode chunk -> one host read -> retire."""
        t0 = _now()
        emitted_before = self.stats.emitted_tokens
        faults_before = self.stats.engine_faults
        chunk_k = 0
        with self._lock:
            self._sweep_cancelled()
            self._admit()
            toks = emitted = None
            if self.active:
                budgets = np.zeros((self.engine.max_batch,), np.int32)
                pending = {id(r) for r, _ in self._pending_first}
                for slot, req in self.active.items():
                    have = len(req.output) + (1 if id(req) in pending else 0)
                    budgets[slot] = max(0, req.max_new_tokens - have)
                if self.engine.paged:
                    self._secure_pages(budgets)
            if self.active:
                # budget-aligned pow2 chunk: never decode past the earliest
                # completion
                k = min(self.decode_chunk,
                        max(1, min(int(budgets[s]) for s in self.active)))
                k = 1 << (k.bit_length() - 1)
                chunk_k = k
                try:
                    if self.faults is not None:
                        # may raise InjectedFault, stall, or raise
                        # WorkerKill: a BaseException that unwinds past
                        # tick (the lock is released) and kills the
                        # driving thread, leaving this tick's first tokens
                        # unread for the watchdog's recovery to drop
                        self.faults.check_chunk(self.stats.ticks,
                                                sorted(self.active))
                    toks, emitted = self.engine.step_chunk(
                        self._gen, self._temps, budgets, k)
                except InjectedFault as e:
                    # scoped: only the named victim retires; the co-batch
                    # skips this chunk (nothing ran) and resumes next tick
                    if e.slot is not None and e.slot in self.active:
                        self._quarantine_slot(e.slot, str(e), e.site)
                    else:
                        self.quarantine_active(str(e), site=e.site)
                    chunk_k = 0
                except Exception as e:
                    # a failed dispatch leaves the co-batch's device state
                    # untrusted: retire it, keep the loop alive
                    self.quarantine_active(f"chunk dispatch failed: {e}",
                                           site="chunk")
                    chunk_k = 0
            try:
                firsts, toks, emitted = self._read(toks, emitted)
            except Exception as e:     # the sync surfaces device failures
                self.quarantine_active(f"chunk sync failed: {e}",
                                       site="chunk")
                firsts, toks, emitted = [], None, None
            for (req, _), first in zip(self._pending_first, firsts):
                req.output.append(first)
                self.stats.emitted_tokens += 1
                self._feed_sink(req, [first])
            self._pending_first.clear()
            if toks is not None:
                counts = emitted.sum(axis=1).astype(np.int32)
                self.engine.commit_chunk(counts)
                per_step = emitted.sum(axis=0)
                self.stats.chunks += 1
                self.stats.decode_steps += int((per_step > 0).sum())
                self.stats.occupancy_sum += int(per_step.sum())
                self.stats.max_occupancy = max(self.stats.max_occupancy,
                                               int(per_step.max(initial=0)))
                for slot, req in list(self.active.items()):
                    n = int(counts[slot])
                    if n:
                        chunk_toks = [int(t) for t in toks[slot, :n]]
                        req.output.extend(chunk_toks)
                        self.stats.emitted_tokens += n
                        self._feed_sink(req, chunk_toks)
                        if req.trace is not None:
                            req.trace.event("chunk", n=n, k=chunk_k,
                                            occupancy=len(self.active))
                    self._maybe_finish(req)
                    if not req.done and (self.engine.context_len(slot)
                                         >= self.engine.max_seq):
                        self._overflow(req)
                if self.stats.engine_faults == faults_before:
                    self.fault_streak = 0         # a clean committed chunk
            if self.tracer is not None:
                # host mirrors only: pool and prefix counts never read the
                # device
                kv = self.engine.blocks_in_use() if self.engine.paged \
                    else None
                pages = None
                if self.engine.prefix_cache is not None:
                    pages = self.engine.prefix_stats().get("cached_pages")
                self.tracer.tick(
                    self.stats.ticks, t0, _now(), k=chunk_k,
                    active=len(self.active),
                    emitted=self.stats.emitted_tokens - emitted_before,
                    kv_blocks_in_use=kv, prefix_cached_pages=pages)
            self.stats.ticks += 1
            self.stats.wall_s += _now() - t0

    def run(self, *, max_ticks: int = 10_000) -> SchedulerStats:
        """Run until queue and active slots drain (or the tick budget)."""
        for _ in range(max_ticks):
            if not self.has_work():
                break
            self.tick()
        return self.stats
