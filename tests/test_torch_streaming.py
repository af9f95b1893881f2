"""The port's streaming v2 surface against the JAX package's, on the CPU.

Both ``MAXServer``s serve reduced ``qwen3-4b`` (max_seq 64, paged, prefix
cache, the JAX package's seed-0 weights bridged into the port) and get the
same requests:

- SSE streams: the same frames (``id``, ``event``, the ``token_ids`` and
  ``text`` of each delta, the ``done`` envelope and usage counts; timing
  fields aside), and the deltas concatenate to predict's tokens;
- jobs: the same event replay, ``Last-Event-ID`` and ``?from_seq=``
  resume, and results equal to predict's;
- cancellation by client disconnect, by ``DELETE`` and by an abandoned
  consumer: each frees its slot, and afterwards the pool invariants hold
  and the pool and prefix counters equal the JAX server's. The scheduler
  ticks are gated one at a time so that each cancel lands after the same
  tokens on both sides;
- the sync service's whole-result fallback.

Greedy decoding only; tokens and counters are compared exactly.
"""

import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.assets  # noqa: E402,F401
from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import reduce_for_smoke  # noqa: E402
from repro.core import EXCHANGE as JAX_EXCHANGE  # noqa: E402
from repro.core import MAXServer as JaxServer  # noqa: E402
from repro.core.registry import ModelRegistry  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import CONFIGS as PORT_CONFIGS  # noqa: E402
from repro_torch.core.api import MAXServer  # noqa: E402
from repro_torch.core.assets import EXCHANGE  # noqa: E402
from repro_torch.core.service import BatchedService  # noqa: E402
from repro_torch.data.tokenizer import TOKENIZER  # noqa: E402
from repro_torch.serving.qos import QoSConfig  # noqa: E402

BUILD_KW = {"max_seq": 64, "max_batch": 2}
SERVICE_KW = {"batch_window_s": 0.01}
MODEL = "qwen3-4b"
DEPLOY = {"paged": True, "page_size": 16, "prefix_cache": True}
TIMING = ("latency_ms", "ttft_ms", "queue_ms", "prefill_ms", "decode_ms",
          "submitted_at", "finished_at")


@pytest.fixture(scope="module")
def params():
    jparams = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"])).init(
        jax.random.PRNGKey(0))       # what the JAX asset builds at seed 0
    return jax.tree_util.tree_map(np.asarray, jparams)


@pytest.fixture(scope="module")
def servers(params):
    reg = ModelRegistry()
    for name in PORT_CONFIGS:
        reg.register(JAX_EXCHANGE.get(name))
    with JaxServer(registry=reg, build_kw=BUILD_KW,
                   service_kw=SERVICE_KW) as js, \
            MAXServer(build_kw={**BUILD_KW, "device": "cpu",
                                "params": params},
                      service_kw=SERVICE_KW) as ts:
        yield js, ts


def _req(server, method, path, payload=None, headers=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(server.url + path, data,
                                 {"Content-Type": "application/json",
                                  **(headers or {})}, method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _read_sse(resp, limit=None):
    """Parse SSE frames into [{'id', 'event', 'data'}, ...] (at most
    ``limit`` frames, then stop reading)."""
    events, cur = [], {}
    for raw in resp:
        line = raw.decode().rstrip("\n")
        if not line:
            if cur:
                events.append(cur)
                cur = {}
                if limit is not None and len(events) >= limit:
                    break
            continue
        key, _, val = line.partition(": ")
        cur[key] = json.loads(val) if key == "data" else val
    if cur:
        events.append(cur)
    return events


def _sse(server, method, path, payload=None, headers=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(server.url + path, data,
                                 {"Content-Type": "application/json",
                                  **(headers or {})}, method=method)
    with urllib.request.urlopen(req) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        assert r.headers.get("Content-Length") is None
        return _read_sse(r)


def _norm(x):
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items() if k not in TIMING}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


def _wait(predicate, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return False


def _deploy(servers, body=None):
    for s in servers:
        code, env = _req(s, "POST", f"/v2/model/{MODEL}/deploy",
                         body if body is not None else DEPLOY)
        assert code == 200, env


def test_stream_frames_equal_jax_and_predict(servers):
    _deploy(servers)
    inp = {"input": {"text": "stream me please", "max_new_tokens": 12}}
    frames, refs = [], []
    for s in servers:
        code, ref = _req(s, "POST", f"/v2/model/{MODEL}/predict", inp)
        assert code == 200
        refs.append(ref)
        frames.append(_sse(s, "POST", f"/v2/model/{MODEL}/stream", inp))
    (jf, tf), (jref, tref) = frames, refs
    assert _norm(tf) == _norm(jf)
    assert [int(e["id"]) for e in tf] == list(range(len(tf)))
    assert [e["event"] for e in tf] == ["token"] * (len(tf) - 1) + ["done"]
    ids = [t for e in tf[:-1] for t in e["data"]["token_ids"]]
    assert TOKENIZER.decode(ids) == \
        tref["predictions"][0]["generated_text"]
    assert "".join(e["data"]["text"] for e in tf[:-1]) == \
        tref["predictions"][0]["generated_text"]
    assert len(tf) - 1 >= 2          # a delta arrives before done
    done = tf[-1]["data"]
    assert done["envelope"]["predictions"] == tref["predictions"] == \
        jref["predictions"]
    usage = done["usage"]
    assert usage["completion_tokens"] == len(ids) == 12
    assert usage["ttft_ms"] <= usage["latency_ms"]
    # the phases run from the scheduler's submit stamp, latency and TTFT
    # from the service's, taken just before it: both differ from the
    # phases by that one offset (each value is rounded to 1 us)
    q, p, d = usage["queue_ms"], usage["prefill_ms"], usage["decode_ms"]
    offset = usage["latency_ms"] - (q + p + d)
    assert offset >= -0.002
    assert abs(offset - (usage["ttft_ms"] - (q + p))) <= 0.004


def test_stream_validation_errors_stay_json(servers):
    for path, body, status, code in [
            (f"/v2/model/{MODEL}/stream", {}, 400, "MISSING_INPUT"),
            ("/v2/model/nope/stream", {"input": "x"}, 404,
             "MODEL_NOT_FOUND"),
            (f"/v2/model/{MODEL}/stream", {"input": "x", "priority": 1},
             400, "INVALID_INPUT")]:
        got = [_req(s, "POST", path, body) for s in servers]
        assert got[1] == got[0]
        assert got[1][0] == status and got[1][1]["error"]["code"] == code


def test_rejection_arrives_as_a_pre_stream_error_event(params):
    svc = BatchedService(
        EXCHANGE.get(MODEL).build(device="cpu", params=params, **BUILD_KW),
        qos=QoSConfig(rate=0.001, burst=1.0))
    try:
        assert svc.predict({"text": "drain the bucket",
                            "max_new_tokens": 2})["status"] == "ok"
        events = list(svc.predict_stream({"text": "rejected",
                                          "max_new_tokens": 2}))
        assert [(e.event, e.seq, e.data["code"]) for e in events] == \
            [("error", 0, "RATE_LIMITED")]
        assert svc.stats()["streams"]["started"] == 1
    finally:
        svc.close()


def test_job_replay_and_resume_equal_jax(servers):
    _deploy(servers)
    inp = {"input": {"text": "job stream", "max_new_tokens": 10}}
    outs = []
    for s in servers:
        code, sub = _req(s, "POST", f"/v2/model/{MODEL}/jobs", inp)
        assert code == 202 and sub["poll"] == f"/v2/jobs/{sub['job']['id']}"
        jid = sub["job"]["id"]
        assert _wait(lambda: _req(s, "GET", f"/v2/jobs/{jid}")[1]["job"]
                     ["state"] == "done")
        full = _sse(s, "GET", f"/v2/jobs/{jid}/events")
        cursor = full[1]["id"]
        resumed = _sse(s, "GET", f"/v2/jobs/{jid}/events",
                       headers={"Last-Event-ID": cursor})
        inclusive = _sse(s, "GET",
                         f"/v2/jobs/{jid}/events?from_seq={cursor}")
        assert resumed == full[2:] and inclusive == full[1:]
        job = _req(s, "GET", f"/v2/jobs/{jid}")[1]["job"]
        code, ref = _req(s, "POST", f"/v2/model/{MODEL}/predict", inp)
        assert job["result"]["predictions"] == ref["predictions"]
        outs.append((full, job))
    (jfull, jjob), (tfull, tjob) = outs
    assert _norm(tfull) == _norm(jfull)
    assert _norm({k: v for k, v in tjob.items() if k != "id"}) == \
        _norm({k: v for k, v in jjob.items() if k != "id"})


def test_job_errors_equal_jax(servers):
    for method, path in [("GET", "/v2/jobs/deadbeef"),
                         ("GET", "/v2/jobs/deadbeef/events"),
                         ("GET", "/v2/jobs/deadbeef/trace"),
                         ("DELETE", "/v2/jobs/deadbeef"),
                         ("GET", "/v2/jobs/x/events?from_seq=oops")]:
        got = [_req(s, method, path) for s in servers]
        assert got[1][0] == got[0][0] == 404, (path, got)
        assert got[1][1] == got[0][1]


# ---------------------------------------------------------------------------
# cancellation, one gated tick at a time
# ---------------------------------------------------------------------------

class TickGate:
    """Let the service's worker run one scheduler tick per ``step``."""

    def __init__(self, scheduler):
        self._orig = scheduler.tick
        self._go = threading.Semaphore(0)
        self._done = threading.Semaphore(0)
        self._open = False
        scheduler.tick = self._tick

    def _tick(self):
        if not self._open:
            self._go.acquire()
        try:
            self._orig()
        finally:
            self._done.release()

    def step(self):
        self._go.release()
        assert self._done.acquire(timeout=60), "tick did not run"

    def open(self):
        self._open = True
        self._go.release()


def _gated(servers):
    _deploy(servers, {**DEPLOY, "page_size": 8})
    svcs = [s.manager.get(MODEL).service for s in servers]
    return svcs, [TickGate(svc.scheduler) for svc in svcs]


def _pool_state(svc):
    eng = svc.engine
    eng.check_pool_invariants()
    return {"kv": eng.kv_stats(), "prefix": eng.prefix_stats(),
            "free_slots": eng.free_slots(),
            "cancelled": svc.scheduler.stats.cancelled}


LONG = {"text": "a prompt that will be cancelled midway", "max_new_tokens": 40}


def _disconnect(server, svc, gate):
    """Real socket, RST after the first tick's token events: the next SSE
    write fails, the event iterator closes, and the request is
    cancelled."""
    body = json.dumps({"input": LONG}).encode()
    host, port = server._server.server_address[:2]
    sock = socket.create_connection((host, port))
    try:
        sock.sendall(
            f"POST /v2/model/{MODEL}/stream HTTP/1.1\r\n"
            f"Host: {host}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        assert _wait(svc.scheduler.has_work)
        gate.step()                   # admission + first chunk
        buf = b""
        # both of the tick's events (first token, chunk) are written
        # before the reset, so the write that fails is the next tick's
        while buf.count(b"event: token") < 2:
            chunk = sock.recv(4096)
            assert chunk, f"connection closed early: {buf!r}"
            buf += chunk
    finally:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()
    gate.step()                       # its event's write fails
    assert _wait(lambda: svc.stats()["streams"]["cancelled"] >= 1)
    gate.step()                       # the sweep frees the slot


def _delete(server, svc, gate):
    code, sub = _req(server, "POST", f"/v2/model/{MODEL}/jobs",
                     {"input": LONG})
    assert code == 202
    jid = sub["job"]["id"]
    assert _wait(svc.scheduler.has_work)
    gate.step()
    assert _wait(lambda: _req(server, "GET", f"/v2/jobs/{jid}")[1]["job"]
                 ["state"] == "running")
    code, out = _req(server, "DELETE", f"/v2/jobs/{jid}")
    assert code == 200 and out["cancelled"] == jid
    gate.step()
    assert _wait(lambda: _req(server, "GET", f"/v2/jobs/{jid}")[1]["job"]
                 ["state"] == "cancelled")
    job = _req(server, "GET", f"/v2/jobs/{jid}")[1]["job"]
    assert job["result"]["status"] == "cancelled"
    events = _sse(server, "GET", f"/v2/jobs/{jid}/events")
    assert [e["event"] for e in events][-1] == "error"
    assert "done" not in [e["event"] for e in events]
    assert events[-1]["data"]["code"] == "CANCELLED"


def _abandon(server, svc, gate):
    """A consumer that stops draining its two-event bridge is abandoned:
    the sink cancels the request instead of decoding into the queue."""
    svc.stream_queue_depth = 2
    gen = svc.predict_stream(LONG)
    first = {}
    th = threading.Thread(target=lambda: first.update(ev=next(gen)))
    th.start()
    assert _wait(svc.scheduler.has_work)
    gate.step()                       # two events land, one is read
    th.join(timeout=60)
    assert first["ev"].event == "token"
    gate.step()                       # the bridge fills
    gate.step()                       # the next push finds it full
    gate.step()                       # the sweep frees the slot
    gen.close()
    svc.stream_queue_depth = 256


@pytest.mark.parametrize("kind", ["disconnect", "delete", "abandoned"])
def test_cancel_frees_the_slot_with_pool_and_prefix_equal_jax(servers,
                                                              kind):
    svcs, gates = _gated(servers)
    run = {"disconnect": _disconnect, "delete": _delete,
           "abandoned": _abandon}[kind]
    try:
        states = []
        for s, svc, gate in zip(servers, svcs, gates):
            run(s, svc, gate)
            assert _wait(lambda: svc.idle())
            states.append(_pool_state(svc))
    finally:
        for gate in gates:
            gate.open()
    jst, tst = states
    assert tst == jst
    assert tst["cancelled"] == 1
    assert tst["free_slots"] == [0, 1]
    assert tst["kv"]["blocks_in_use"] == 0
    assert svcs[1].stats()["cancelled"] == svcs[0].stats()["cancelled"] == 1
    # the freed slot serves the next request with predict's tokens
    inp = {"input": {"text": "after the cancel", "max_new_tokens": 5}}
    got = [_req(s, "POST", f"/v2/model/{MODEL}/predict", inp)
           for s in servers]
    assert got[1][1]["predictions"] == got[0][1]["predictions"]


def test_delete_cancels_queued_job_without_touching_a_slot(params):
    svc = BatchedService(
        EXCHANGE.get(MODEL).build(device="cpu", params=params, max_seq=64,
                                  max_batch=1),
        batch_window_s=0.0)
    gate = TickGate(svc.scheduler)
    try:
        running = svc.submit_job({"text": "holds the slot",
                                  "max_new_tokens": 30})
        queued = svc.submit_job({"text": "never runs",
                                 "max_new_tokens": 30})
        gate.step()
        assert svc.cancel_job(queued.id) is True
        gate.step()
        assert _wait(lambda: queued.state == "cancelled")
        assert queued.result["error"] == "cancelled before starting"
        assert not any(e.event == "token"
                       for e in queued.stream.subscribe(0, timeout_s=1))
        assert svc.scheduler.stats.prefills == 1
        gate.open()
        assert _wait(lambda: running.state == "done")
        assert svc.cancel_job(running.id) is False      # already finished
        assert svc.delete_job(running.id) is True
    finally:
        gate.open()
        svc.close()


def test_sync_stream_is_the_whole_result_fallback(servers):
    _deploy(servers, {"service": "sync"})
    inp = {"input": {"text": "whole result", "max_new_tokens": 7}}
    frames = [_sse(s, "POST", f"/v2/model/{MODEL}/stream", inp)
              for s in servers]
    jf, tf = frames
    assert [e["event"] for e in tf] == ["token", "done"]
    assert [e["id"] for e in tf] == ["0", "1"]
    assert _norm(tf) == _norm(jf)
    preds = tf[0]["data"]["predictions"]
    assert tf[1]["data"]["envelope"]["predictions"] == preds
    code, ref = _req(servers[1], "POST", f"/v2/model/{MODEL}/predict", inp)
    assert _norm(ref["predictions"]) == _norm(preds)
    bad = [_sse(s, "POST", f"/v2/model/{MODEL}/stream",
                {"input": {"no_text": 1}}) for s in servers]
    assert bad[1] == bad[0]
    assert bad[1][0]["data"]["code"] == "INVALID_INPUT"


def test_stats_surface_streaming_metrics(servers):
    _deploy(servers)
    _sse(servers[1], "POST", f"/v2/model/{MODEL}/stream",
         {"input": {"text": "tick", "max_new_tokens": 3}})
    code, body = _req(servers[1], "GET", f"/v2/model/{MODEL}/stats")
    svc = body["service"]
    assert svc["streams"] == {"active": 0, "started": 1, "cancelled": 0}
    assert svc["ttft"]["count"] >= 1 and svc["inter_token"]["count"] >= 1
    jsvc = _req(servers[0], "GET", f"/v2/model/{MODEL}/stats")[1]["service"]
    assert set(svc) - {"engine_faults", "prefills"} == set(jsvc)
    # equal robustness counters, but for stalls: a JAX tick that compiles
    # may outlast the stall budget
    rob, jrob = (dict(x["robustness"], tick_stalls=None) for x in (svc, jsvc))
    assert rob == jrob


def test_cancel_is_not_starved_by_back_to_back_ticks(params):
    """A cancel from a request thread returns at once while the worker
    ticks back to back, each tick holding the scheduler lock through a
    0.2 s wait that releases the GIL as a device read does: the chunk in
    flight, if any, is the last one run. (The starvation this guards
    against, a worker retaking the lock before a waiting cancel runs,
    showed on the card, 17 chunks late; this CPU timing does not provoke
    it.)"""
    svc = BatchedService(
        EXCHANGE.get(MODEL).build(device="cpu", params=params, max_seq=64,
                                  max_batch=1, decode_chunk=1),
        batch_window_s=0.0)
    sched, step_chunk = svc.scheduler, svc.engine.step_chunk

    def slow_chunk(*a, **kw):
        time.sleep(0.2)
        return step_chunk(*a, **kw)
    svc.engine.step_chunk = slow_chunk
    stamps, cancel = [], sched.cancel

    def stamped_cancel(rid):
        stamps.append(sched.stats.chunks)
        out = cancel(rid)
        stamps.append(sched.stats.chunks)
        return out
    sched.cancel = stamped_cancel
    try:
        job = svc.submit_job({"text": "long", "max_new_tokens": 55})
        assert _wait(lambda: job.state == "running")
        assert svc.cancel_job(job.id) is True
        assert _wait(svc.idle)
        assert job.state == "cancelled"
        entered, marked = stamps
        assert marked == entered
        assert sched.stats.chunks - marked <= 1
    finally:
        svc.close()


def test_waiter_count_survives_concurrent_cancels_and_polls(params):
    """More threads than cores cancel and poll without pause while the
    worker ticks, with a short switch interval: every request still
    retires, and each cancelled job is counted once (cancel and poll take
    no lock, so none of them can hold the worker off)."""
    import os
    import sys
    svc = BatchedService(
        EXCHANGE.get(MODEL).build(device="cpu", params=params, max_seq=64,
                                  max_batch=2, decode_chunk=2),
        batch_window_s=0.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        jobs = [svc.submit_job({"text": f"job {i}", "max_new_tokens": 20})
                for i in range(6)]
        stop = threading.Event()

        def hammer(i):
            while not stop.is_set():
                svc.scheduler.poll(i % 7)
                if i % 3 == 0:
                    svc.cancel_job(jobs[i % len(jobs)].id)

        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range((os.cpu_count() or 2) + 4)]
        for t in threads:
            t.start()
        assert _wait(lambda: all(j.state in ("done", "cancelled")
                                 for j in jobs), 60)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert _wait(svc.idle)
        n_cancelled = sum(j.state == "cancelled" for j in jobs)
        assert svc.jobs_cancelled == n_cancelled
        # a cancel that raced completion is a cancelled job, not a
        # cancelled scheduler request
        assert 0 < svc.scheduler.stats.cancelled <= n_cancelled
    finally:
        sys.setswitchinterval(interval)
        svc.close()
