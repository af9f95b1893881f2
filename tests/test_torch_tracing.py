"""The port's request tracing against the JAX package's, on the CPU.

- ``serving/tracing.py`` is a copy: the same recorded operations give the
  same timeline JSON, the same Chrome trace-event export (the schema of
  ``tests/test_tracing.py``, and byte for byte the same events) and the
  same ring bounds and slow-request compaction; phase sums are exact.
- The port's scheduler records, for the same requests on reduced
  ``qwen3-4b`` with bridged weights, the same event names per request as
  the JAX scheduler (submit, QoS enqueue/grant, admit with the prefix-cache
  summary, first token, chunks, cancel, retire), and the phases of every
  trace sum exactly to its end-to-end time.
- Over HTTP: ``/v2/jobs/{id}/trace`` and ``/v2/trace/export`` answer as
  the JAX server's do, and the deploy trace knobs validate alike.

Phases are exact differences of shared stamps; each is rounded to 1 µs on
its own, so a sum of three is held to its e2e within 0.002 ms. Clock
values themselves differ between runs and are not compared.
"""

import json
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
from repro.serving import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serving import GenerationEngine as JaxEngine  # noqa: E402
from repro.serving import qos as jax_qos  # noqa: E402
from repro.serving import tracing as jax_tracing  # noqa: E402
from repro_torch.configs import CONFIGS as PORT_CONFIGS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.core.api import MAXServer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import to_torch_params  # noqa: E402
from repro_torch.serving import qos as port_qos  # noqa: E402
from repro_torch.serving import tracing as port_tracing  # noqa: E402
from repro_torch.serving.engine import GenerationEngine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousBatchingScheduler  # noqa: E402

TRACING = pytest.mark.parametrize("tracing", [jax_tracing, port_tracing],
                                  ids=["jax", "port"])


def _finish_one(tracer, tid, *, e2e_s, chunks=3, slot=0):
    t0 = 1000.0 + tid
    tr = tracer.start(tid, submitted_at=t0, priority="batch", client="c")
    tr.admitted(t0 + e2e_s * 0.25, slot=slot, tick=tid,
                admission={"prompt_tokens": 9, "cached_hit_tokens": 8,
                           "pages_allocated": 1, "cow": False})
    tr.first_token(t0 + e2e_s * 0.5)
    for i in range(chunks):
        tr.event("chunk", t0 + e2e_s * 0.6 + i * 1e-4, n=1, k=4, occupancy=1)
    tr.event("cancel", t0 + e2e_s * 0.9, ran=True, generated=chunks)
    tracer.finish(tr, outcome="ok", tick=tid + 3, completion_tokens=chunks,
                  ts=t0 + e2e_s)


def _record(tracing):
    tracer = tracing.Tracer(model="m", capacity=3, slow_trace_ms=50.0)
    tracer.tick(1, 5.0, 5.002, k=4, active=2, emitted=8,
                kv_blocks_in_use=5, prefix_cached_pages=3)
    tracer.tick(2, 5.003, 5.004, k=2, active=1, emitted=2)
    for tid, e2e in enumerate((0.001, 0.2, 0.001, 0.001, 0.3)):
        _finish_one(tracer, tid, e2e_s=e2e, slot=tid % 2)
    live = tracer.start(99, submitted_at=1200.0)
    live.admitted(1200.5, slot=1, tick=7)
    live.first_token(1200.6)
    live.finished_at = 1201.0          # pin "now" for a live trace
    return tracer


def test_timelines_and_export_equal_jax():
    jt, tt = _record(jax_tracing), _record(port_tracing)
    for tid in (2, 3, 4, 99):
        assert tt.get(tid) == jt.get(tid)
    assert tt.get(0) is None and jt.get(0) is None     # ring evicted
    assert tt.snapshot_stats() == jt.snapshot_stats()
    assert tt.to_chrome(pid=2, process_name="demo") == \
        jt.to_chrome(pid=2, process_name="demo")
    assert tt.next_id() == jt.next_id() >= (1 << 30)


def _validate_chrome_events(events):
    """The subset of the Chrome trace-event schema the export uses (as
    ``tests/test_tracing.py`` checks it)."""
    assert isinstance(events, list) and events
    json.dumps(events)
    for ev in events:
        assert ev["ph"] in ("X", "C", "M", "i"), ev
        assert isinstance(ev["pid"], int)
        assert isinstance(ev["tid"], int)
        assert isinstance(ev["name"], str) and ev["name"]
        if ev["ph"] == "X":
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] > 0
        elif ev["ph"] == "C":
            assert isinstance(ev["ts"], (int, float))
            assert ev["args"]
        elif ev["ph"] == "i":
            assert ev["s"] in ("t", "p", "g")


@TRACING
def test_phase_sum_is_exact_and_schema_holds(tracing):
    tr = tracing.RequestTrace(1, submitted_at=100.0)
    tr.admitted(100.5, slot=0, tick=10)
    tr.first_token(100.7)
    tr.first_token(100.9)                        # idempotent
    t = tracing.Tracer()
    t._live[1] = tr
    t.finish(tr, outcome="ok", tick=14, completion_tokens=8, ts=101.0)
    p = tr.phases()
    assert p == {"queue_ms": 500.0, "prefill_ms": 200.0,
                 "decode_ms": 300.0, "e2e_ms": 1000.0, "sched_ticks": 5}
    _validate_chrome_events(_record(tracing).to_chrome(pid=3))


def test_serving_clock_is_monotonic_like_jax():
    a = port_tracing.now()
    b = jax_tracing.now()
    c = port_tracing.now()
    assert a <= b <= c                  # one clock: time.monotonic


# ---------------------------------------------------------------------------
# scheduler spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"]))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = to_torch_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(t_reduce(get_config("qwen3-4b"))), tparams


SHARED = list(range(3, 21))


def _traced_run(models, side, *, qos):
    jm, jparams, tm, tparams = models
    kw = dict(max_batch=2, max_seq=64, decode_chunk=4, paged=True,
              page_size=8, prefix_cache=True)
    if side == "jax":
        eng = JaxEngine(jm, jparams, **kw)
        mods = (JaxScheduler, jax_qos, jax_tracing)
    else:
        eng = GenerationEngine(tm, tparams, device="cpu", **kw)
        mods = (ContinuousBatchingScheduler, port_qos, port_tracing)
    Sched, qosmod, tracing = mods
    tracer = tracing.Tracer(model="m")
    sched = Sched(eng, tracer=tracer,
                  admission=qosmod.AdmissionController(qosmod.QoSConfig())
                  if qos else None)
    reqs = [sched.submit(SHARED + [30 + i], max_new_tokens=6)
            for i in range(3)]
    doomed = sched.submit([7, 8, 9], max_new_tokens=20)
    sched.tick()
    sched.cancel(doomed.id)
    sched.run()
    return sched, reqs + [doomed]


@pytest.mark.parametrize("qos", [False, True], ids=["fifo", "qos"])
def test_scheduler_traces_equal_jax_and_sum_exactly(models, qos):
    runs = [_traced_run(models, side, qos=qos) for side in ("jax", "port")]
    (js, jreqs), (ts, treqs) = runs
    for jr, tr in zip(jreqs, treqs):
        jt, tt = js.tracer.get(jr.id), ts.tracer.get(tr.id)
        assert [e["name"] for e in tt["events"]] == \
            [e["name"] for e in jt["events"]]
        assert [e.get("attrs") for e in tt["events"]] == \
            [e.get("attrs") for e in jt["events"]]
        for key in ("outcome", "error_code", "slot", "admission",
                    "completion_tokens", "priority", "client"):
            assert tt[key] == jt[key], key
        p = tt["phases"]
        assert p["sched_ticks"] == jt["phases"]["sched_ticks"]
        # exact before rounding; each phase is rounded to 1 µs on its own
        assert abs(p["queue_ms"] + p["prefill_ms"] + p["decode_ms"]
                   - p["e2e_ms"]) <= 0.002
    warm = ts.tracer.get(treqs[2].id)["admission"]
    assert warm["cached_hit_tokens"] == 16        # two shared pages
    assert ts.tracer.get(treqs[3].id)["outcome"] == "CANCELLED"
    names = {e["name"] for e in ts.tracer.to_chrome(pid=1)}
    assert "tick 0" in names and "kv_pool_blocks_in_use" in names
    assert ts.tracer.snapshot_stats() == js.tracer.snapshot_stats()


def test_tracing_does_not_change_tokens(models):
    _, _, tm, tparams = models
    outs = []
    for tracer in (None, port_tracing.Tracer()):
        eng = GenerationEngine(tm, tparams, device="cpu", max_batch=2,
                               max_seq=64, decode_chunk=4)
        sched = ContinuousBatchingScheduler(eng, tracer=tracer)
        reqs = [sched.submit(SHARED + [i], max_new_tokens=9)
                for i in range(3)]
        sched.run()
        outs.append([r.output for r in reqs])
        assert sched.stats.host_reads <= sched.stats.ticks
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# over HTTP
# ---------------------------------------------------------------------------

BUILD_KW = {"max_seq": 64, "max_batch": 2}


@pytest.fixture(scope="module")
def servers():
    reg = ModelRegistry()
    for name in PORT_CONFIGS:
        reg.register(JAX_EXCHANGE.get(name))
    jparams = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"])).init(
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jparams)
    with JaxServer(registry=reg, build_kw=BUILD_KW,
                   service_kw={"batch_window_s": 0.01}) as js, \
            MAXServer(build_kw={**BUILD_KW, "device": "cpu",
                                "params": params},
                      service_kw={"batch_window_s": 0.01}) as ts:
        yield js, ts


def _req(server, method, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(server.url + path, data,
                                 {"Content-Type": "application/json"},
                                 method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _done_job(server, body):
    code, sub = _req(server, "POST", "/v2/model/qwen3-4b/jobs", body)
    assert code == 202
    jid = sub["job"]["id"]
    deadline = time.monotonic() + 60
    while _req(server, "GET", f"/v2/jobs/{jid}")[1]["job"]["state"] \
            not in ("done", "error", "cancelled"):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    return jid


def test_job_trace_endpoint_equals_jax(servers):
    traces = []
    for s in servers:
        assert _req(s, "POST", "/v2/model/qwen3-4b/deploy",
                    {"paged": True, "prefix_cache": True,
                     "slow_trace_ms": 1000})[0] == 200
        jid = _done_job(s, {"input": {"text": "trace me", "max_new_tokens":
                                      7}, "priority": "interactive",
                            "client": "alice"})
        code, body = _req(s, "GET", f"/v2/jobs/{jid}/trace")
        assert code == 200 and body["job_id"] == jid
        traces.append(body["trace"])
    jt, tt = traces
    assert [e["name"] for e in tt["events"]] == \
        [e["name"] for e in jt["events"]]
    for key in ("priority", "client", "prompt_tokens", "max_new_tokens",
                "completion_tokens", "outcome", "admission", "slot"):
        assert tt[key] == jt[key], key
    p = tt["phases"]
    assert abs(p["queue_ms"] + p["prefill_ms"] + p["decode_ms"]
               - p["e2e_ms"]) <= 0.002      # sum of three 1 µs roundings
    assert [s["name"] for s in tt["spans"]] == ["queue", "prefill",
                                                "decode"]


def test_trace_export_and_stats_equal_jax(servers):
    outs = []
    for s in servers:
        code, body = _req(s, "GET", "/v2/trace/export")
        assert code == 200 and body["displayTimeUnit"] == "ms"
        _validate_chrome_events(body["traceEvents"])
        outs.append(body)
        code, st = _req(s, "GET", "/v2/model/qwen3-4b/stats")
        assert st["service"]["tracing"]["enabled"] is True
        assert st["service"]["tracing"]["slow_trace_ms"] == 1000.0

    def shape(body):
        return sorted({(e["ph"], e.get("cat", ""), e["tid"] >= 1000)
                       for e in body["traceEvents"]})
    assert shape(outs[1]) == shape(outs[0])


@pytest.mark.parametrize("body", [
    {"trace": "yes"}, {"trace_buffer": 0}, {"trace_buffer": True},
    {"slow_trace_ms": -1}, {"trace": False, "trace_buffer": 8},
    {"trace": False, "slow_trace_ms": 5}, {"qos": []},
    {"qos": {"policy": "lifo"}}, {"qos": {"nope": 1}},
])
def test_deploy_knob_validation_equals_jax(servers, body):
    got = [_req(s, "POST", "/v2/model/qwen3-4b/deploy", body)
           for s in servers]
    assert got[1][0] == got[0][0] == 400
    assert got[1][1]["error"] == got[0][1]["error"]


def test_trace_disabled_then_enabled(servers):
    for s in servers:
        assert _req(s, "POST", "/v2/model/qwen3-4b/deploy",
                    {"trace": False})[0] == 200
        jid = _done_job(s, {"input": {"text": "untraced",
                                      "max_new_tokens": 2}})
        code, body = _req(s, "GET", f"/v2/jobs/{jid}/trace")
        assert code == 404 and body["error"]["code"] == "TRACE_NOT_FOUND"
        st = _req(s, "GET", "/v2/model/qwen3-4b/stats")[1]["service"]
        assert st["tracing"] == {"enabled": False}
        assert _req(s, "POST", "/v2/model/qwen3-4b/deploy",
                    {"trace_buffer": 4})[0] == 200
        jid = _done_job(s, {"input": {"text": "traced",
                                      "max_new_tokens": 2}})
        assert _req(s, "GET", f"/v2/jobs/{jid}/trace")[0] == 200
