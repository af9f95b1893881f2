"""The port's QoS admission and metrics against the JAX package's, on the
CPU.

- ``serving/qos.py`` and ``serving/metrics.py`` are copies: the same
  operations give the same Prometheus text (uptime line aside) and JSON,
  and the same tickets give the same grant order (a hypothesis property
  after ``tests/test_qos.py::test_no_priority_class_starves``, run on both
  controllers side by side).
- The scheduler under an ``AdmissionController`` on reduced ``qwen3-4b``
  with bridged weights, paged and prefix-cached with a pool small enough
  to defer granted requests: the same admission order (tick and slot of
  each request), the same deferred park/unpark events and the same greedy
  tokens as the JAX scheduler; deadline shedding never touches a slot.
- Over HTTP: a per-client rate limit answers 429 ``RATE_LIMITED`` with
  ``Retry-After`` on both servers, a deadline that cannot be met answers
  504 ``DEADLINE_EXCEEDED``, invalid QoS fields answer 400, and
  ``/v2/metrics`` renders the same series.

Tokens and orders are compared exactly; there is no float tolerance here.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

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
from repro.serving import metrics as jax_metrics  # noqa: E402
from repro.serving import qos as jax_qos  # noqa: E402
from repro.serving.tracing import Tracer as JaxTracer  # noqa: E402
from repro_torch.configs import CONFIGS as PORT_CONFIGS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.core.api import ERROR_STATUS, MAXServer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import to_torch_params  # noqa: E402
from repro_torch.serving import metrics as port_metrics  # noqa: E402
from repro_torch.serving import qos as port_qos  # noqa: E402
from repro_torch.serving.scheduler import ContinuousBatchingScheduler  # noqa: E402
from repro_torch.serving.engine import GenerationEngine  # noqa: E402
from repro_torch.serving.tracing import Tracer  # noqa: E402

PKGS = pytest.mark.parametrize("qos,metrics", [(jax_qos, jax_metrics),
                                               (port_qos, port_metrics)],
                               ids=["jax", "port"])


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _ops(metrics):
    """One fixed sequence of registry operations."""
    reg = metrics.MetricsRegistry()
    reg.describe("max_requests_total", "requests by outcome")
    reg.inc("max_requests_total", 2, model="m", outcome="ok")
    reg.inc("max_requests_total", 1, model="m", outcome="rate_limited")
    reg.inc("max_generated_tokens_total", 17, model="m")
    for v in (0.0004, 0.02, 0.3, 0.3, 7.0, 45.0):
        reg.observe("max_queue_wait_seconds", v, model="m",
                    **{"class": "batch"})
    h = reg.histogram("max_inter_token_seconds",
                      buckets=metrics.TOKEN_LATENCY_BUCKETS, model="m")
    for v in (0.0001, 0.004, 0.03):
        h.observe(v)
    reg.register_gauge("max_queue_depth", lambda: 3, model="m")
    reg.register_gauge("max_kv_pool_blocks_in_use", lambda: 7, model="m")
    reg.register_gauge("max_other", lambda: 1, model="n")
    reg.unregister_gauges(model="n")
    reg.inc("max_label_escape_total", 1, model='we"ird\\name\n')
    return reg


def _no_uptime(text):
    return "\n".join(line for line in text.splitlines()
                     if not line.startswith("max_uptime_seconds "))


def test_prometheus_text_equals_jax():
    want = _ops(jax_metrics).to_prometheus()
    got = _ops(port_metrics).to_prometheus()
    assert _no_uptime(got) == _no_uptime(want)
    assert "max_uptime_seconds " in got


def test_json_rendering_equals_jax():
    want = _ops(jax_metrics).to_json()
    got = _ops(port_metrics).to_json()
    want.pop("uptime_s")
    assert got.pop("uptime_s") >= 0
    assert got == want


def test_bucket_constants_equal_jax():
    assert port_metrics.DEFAULT_BUCKETS == jax_metrics.DEFAULT_BUCKETS
    assert port_metrics.TOKEN_LATENCY_BUCKETS == \
        jax_metrics.TOKEN_LATENCY_BUCKETS
    assert port_qos.PRIORITIES == jax_qos.PRIORITIES
    assert dict(port_qos.DEFAULT_CLASS_WEIGHTS) == \
        dict(jax_qos.DEFAULT_CLASS_WEIGHTS)


def _drain(qos, classes, cfg_kw, costs=None):
    clock = FakeClock()
    ctl = qos.AdmissionController(qos.QoSConfig(**cfg_kw), clock=clock,
                                  model_id="m")
    for i, cls in enumerate(classes):
        ctl.submit((cls, i), priority=cls, client=f"client{i % 3}",
                   cost=costs[i] if costs else 1.0)
    order = []
    while ctl.depth():
        admitted, shed = ctl.take(1 + len(order) % 2)
        assert not shed
        order += [(t.item, t.priority, t.client, t.cost) for t in admitted]
    return order, ctl.stats()


@settings(max_examples=15, deadline=None)
@given(classes=st.lists(
    st.sampled_from(["interactive", "batch", "best_effort"]),
    min_size=3, max_size=40),
    policy=st.sampled_from(["drr", "fifo"]),
    costs=st.none() | st.lists(st.integers(1, 40), min_size=40,
                               max_size=40))
def test_grant_order_equals_jax(classes, policy, costs):
    """Property: the same tickets drain in the same order from both
    controllers, under both policies and with token-unit costs."""
    cfg = {"policy": policy}
    want = _drain(jax_qos, classes, cfg, costs)
    got = _drain(port_qos, classes, cfg, costs)
    assert got == want
    assert len(got[0]) == len(classes)


@PKGS
def test_rate_limit_queue_cap_and_deadline_shed(qos, metrics):
    """Token bucket (refill on the injected clock), the per-class queue
    cap and deadline shedding, run on each package's controller: the
    outcomes and the metric series are the same."""
    clock = FakeClock()
    reg = metrics.MetricsRegistry()
    ctl = qos.AdmissionController(
        qos.QoSConfig(rate=2.0, burst=2.0, max_queue=2), clock=clock,
        metrics=reg, model_id="m")
    log = []
    for i, client in enumerate("aaba"):
        try:
            ctl.submit(i, client=client, priority="batch",
                       deadline_s=1.0 if i == 0 else None)
            log.append("ok")
        except qos.AdmissionError as e:
            log.append(e.code)
    clock.t = 2.0                       # bucket refills; ticket 0 expires
    admitted, shed = ctl.take(4)
    log.append(([t.item for t in admitted], [t.item for t in shed]))
    with pytest.raises(qos.InvalidPriority):
        ctl.submit(9, priority="urgent")
    assert log == ["ok", "ok", "QUEUE_FULL", "RATE_LIMITED", ([1], [0])]
    stats = ctl.stats()
    assert (stats["shed"], stats["rate_limited"], stats["queue_full"]) == \
        (1, 1, 1)
    text = reg.to_prometheus()
    assert 'max_shed_total{class="batch",model="m"} 1.0' in text
    for outcome in ("rate_limited", "queue_full"):
        assert ('max_requests_total{class="batch",model="m",'
                f'outcome="{outcome}"}} 1.0') in text


@pytest.mark.parametrize("kw", [{"policy": "lifo"}, {"rate_unit": "byte"},
                                {"max_queue": 0}, {"quantum": 0},
                                {"rate": -1}, {"class_weights": {"a": 0}}])
def test_bad_configs_rejected_alike(kw):
    for qos in (jax_qos, port_qos):
        with pytest.raises(ValueError):
            qos.QoSConfig(**kw)
    with pytest.raises(ValueError):
        port_qos.QoSConfig.from_json({"nope": 1})
    assert port_qos.QoSConfig().request_cost(None) == 1.0
    tok = port_qos.QoSConfig(rate_unit="token")
    assert tok.request_cost(None) == jax_qos.QoSConfig(
        rate_unit="token").request_cost(None) == 16.0


def test_error_status_covers_qos_codes():
    assert ERROR_STATUS["RATE_LIMITED"] == 429
    assert ERROR_STATUS["DEADLINE_EXCEEDED"] == 504
    from repro.core.api import ERROR_STATUS as JAX_STATUS
    assert ERROR_STATUS["DEGRADED"] == ERROR_STATUS["CIRCUIT_OPEN"] == 503
    assert {k: v for k, v in JAX_STATUS.items()
            if k != "INVALID_MESH_SLICE"} == {
        k: v for k, v in ERROR_STATUS.items() if k != "NOT_IMPLEMENTED"}


# ---------------------------------------------------------------------------
# the scheduler under QoS, paged and deferred
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"]))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = to_torch_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(t_reduce(get_config("qwen3-4b"))), tparams


def _schedulers(models, *, max_batch, pool, qos_kw=None, prefix=True):
    jm, jparams, tm, tparams = models
    kw = dict(max_batch=max_batch, max_seq=64, decode_chunk=4, paged=True,
              page_size=8, kv_pool_blocks=pool, prefix_cache=prefix)
    out = []
    for Engine, Sched, qos, Trc, ekw in (
            (JaxEngine, JaxScheduler, jax_qos, JaxTracer, {}),
            (GenerationEngine, ContinuousBatchingScheduler, port_qos, Tracer,
             {"device": "cpu"})):
        eng = Engine(*((jm, jparams) if Engine is JaxEngine
                       else (tm, tparams)), **kw, **ekw)
        ctl = qos.AdmissionController(qos.QoSConfig(**(qos_kw or {})))
        out.append(Sched(eng, admission=ctl, tracer=Trc(model="m")))
    return out


# (prompt, priority, client, max_new_tokens): a batch backlog, then
# interactive work; the 30-token prompts need 4 pages each of a 6-page
# pool, so a granted one waits for pages while a slot is free
SHARED = list(range(3, 19))
WORK = [(SHARED + [40 + i], "batch", f"c{i % 2}", 6) for i in range(2)] + \
       [(list(range(50, 80)), "best_effort", "c9", 9),
        (list(range(200, 230)), "batch", "c1", 4),
        (SHARED + [90], "interactive", "c0", 5),
        (list(range(100, 130)), "interactive", "c1", 7)]


def _run(sched, work):
    reqs = [sched.submit(p, max_new_tokens=n, priority=pri, client=cl)
            for p, pri, cl, n in work]
    stats = sched.run()
    sched.engine.check_pool_invariants()
    return reqs, stats


def _trace_names(tracer, rid):
    return [e["name"] for e in tracer.get(rid)["events"]]


def test_admission_order_and_tokens_equal_jax_paged_deferred(models):
    """max_batch 2 over a 6-page pool: granted interactive work overtakes
    the batch backlog, granted work the pool cannot seat parks in the
    deferred queue and keeps its place, and both schedulers admit the
    same requests at the same ticks into the same slots, with the same
    greedy tokens and the same pool and prefix counters."""
    js, ts = _schedulers(models, max_batch=2, pool=6)
    jreqs, jstats = _run(js, WORK)
    treqs, tstats = _run(ts, WORK)
    key = [(r.admitted_at_tick, r.slot, r.finished_at_tick, r.error_code)
           for r in treqs]
    assert key == [(r.admitted_at_tick, r.slot, r.finished_at_tick,
                    r.error_code) for r in jreqs]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(len(r.output) == n for r, (_, _, _, n) in zip(treqs, WORK))
    assert (tstats.completed, tstats.shed, tstats.prefills, tstats.chunks) \
        == (jstats.completed, jstats.shed, jstats.prefills, jstats.chunks)
    assert ts.engine.prefix_stats() == js.engine.prefix_stats()
    assert ts.engine.kv_stats() == js.engine.kv_stats()
    names = [_trace_names(ts.tracer, r.id) for r in treqs]
    assert names == [_trace_names(js.tracer, r.id) for r in jreqs]
    assert any("deferred_park" in n for n in names)     # deferral happened
    # interactive work submitted last was admitted before the last batch
    assert max(r.admitted_at_tick for r in treqs[4:]) < \
        treqs[3].admitted_at_tick


@pytest.mark.parametrize("policy", ["drr", "fifo"])
def test_fifo_policy_and_token_costs_equal_jax(models, policy):
    js, ts = _schedulers(models, max_batch=1, pool=None, prefix=False,
                         qos_kw={"policy": policy, "rate_unit": "token"})
    jreqs, _ = _run(js, WORK)
    treqs, _ = _run(ts, WORK)
    assert [r.admitted_at_tick for r in treqs] == \
        [r.admitted_at_tick for r in jreqs]
    assert [r.output for r in treqs] == [r.output for r in jreqs]


def test_deadline_shed_never_touches_a_slot(models):
    js, ts = _schedulers(models, max_batch=1, pool=None)
    for sched in (js, ts):
        hold = sched.submit(list(range(1, 9)), max_new_tokens=12)
        doomed = sched.submit([5, 6, 7], max_new_tokens=4, deadline_s=0.0,
                              priority="interactive")
        stats = sched.run()
        assert doomed.error_code == "DEADLINE_EXCEEDED"
        assert doomed.slot == -1 and doomed.output == []
        assert hold.error_code is None and len(hold.output) == 12
        assert stats.shed == 1 and stats.completed == 1
        assert "qos_shed" in _trace_names(sched.tracer, doomed.id)
    assert ts.stats.prefills == js.stats.prefills == 1


def test_one_host_read_per_tick_with_sinks(models):
    """Token sinks are fed from the tick's single host read: the port's
    reads never exceed its ticks, every chunk is read, and the sinks see
    exactly the JAX scheduler's per-tick deliveries."""
    js, ts = _schedulers(models, max_batch=2, pool=6)
    delivered = ([], [])
    for sched, log in zip((js, ts), delivered):
        for i, (p, pri, cl, n) in enumerate(WORK):
            sched.submit(p, max_new_tokens=n, priority=pri, client=cl,
                         token_sink=lambda toks, i=i, log=log:
                         log.append((i, list(toks))))
        sched.run()
    assert delivered[1] == delivered[0]
    assert all(isinstance(t, int) for _, toks in delivered[1] for t in toks)
    st_ = ts.stats
    assert st_.chunks <= st_.host_reads <= st_.ticks


# ---------------------------------------------------------------------------
# over HTTP
# ---------------------------------------------------------------------------

BUILD_KW = {"max_seq": 64, "max_batch": 2}
# a stall budget no CPU tick reaches (a JAX tick that compiles could pass
# the default 5 s and add a series the other server lacks)
SERVICE_KW = {"batch_window_s": 0.01, "stall_budget_s": 600.0}


@pytest.fixture(scope="module")
def servers():
    reg = ModelRegistry()
    for name in PORT_CONFIGS:
        reg.register(JAX_EXCHANGE.get(name))
    jparams = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"])).init(
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jparams)
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
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_per_client_rate_limit_answers_429_with_retry_after(servers):
    for s in servers:
        code, _, _ = _req(s, "POST", "/v2/model/qwen3-4b/deploy",
                          {"qos": {"rate": 0.001, "burst": 1}})
        assert code == 200
        body = {"input": {"text": "hi", "max_new_tokens": 2}}
        code, _, _ = _req(s, "POST", "/v2/model/qwen3-4b/predict", body,
                          {"X-MAX-Client": "alice"})
        assert code == 200
        code, hdrs, raw = _req(s, "POST", "/v2/model/qwen3-4b/predict",
                               {**body, "client": "bob"},
                               {"X-MAX-Client": "alice"})  # header wins
        assert code == 429 and hdrs["Retry-After"] == "1"
        assert json.loads(raw)["error"]["code"] == "RATE_LIMITED"
        code, hdrs, raw = _req(s, "POST", "/v2/model/qwen3-4b/jobs", body,
                               {"X-MAX-Client": "alice"})
        assert code == 429 and hdrs["Retry-After"] == "1"
        code, _, _ = _req(s, "POST", "/v2/model/qwen3-4b/predict",
                          {**body, "client": "bob"})
        assert code == 200                      # bob has his own bucket
        _, _, raw = _req(s, "GET", "/v2/model/qwen3-4b/stats")
        assert json.loads(raw)["service"]["qos"]["rate_limited"] == 2


@pytest.mark.parametrize("body", [
    {"input": "x", "priority": "urgent"},
    {"input": "x", "priority": 3},
    {"input": "x", "client": ""},
    {"input": "x", "deadline_ms": -5},
    {"input": "x", "deadline_ms": True},
])
def test_invalid_qos_fields_are_400_alike(servers, body):
    got = [_req(s, "POST", "/v2/model/qwen3-4b/predict", body)
           for s in servers]
    (jc, _, jraw), (tc, _, traw) = got
    assert tc == jc == 400
    assert json.loads(traw)["error"] == json.loads(jraw)["error"]


def test_unmeetable_deadline_answers_504(servers):
    """A request queued behind a held batch with a 1 ms start-by deadline
    is shed with DEADLINE_EXCEEDED and never runs."""
    for s in servers:
        assert _req(s, "POST", "/v2/model/qwen3-4b/deploy",
                    {"qos": {"max_queue": 8}})[0] == 200
        hold = [threading.Thread(target=_req, args=(
            s, "POST", "/v2/model/qwen3-4b/predict",
            {"input": {"text": f"hold {i}", "max_new_tokens": 40}}))
            for i in range(2)]
        for t in hold:
            t.start()
        svc = s.manager.get("qwen3-4b").service
        deadline = time.time() + 30
        while svc.scheduler.active_count() < 2 and time.time() < deadline:
            time.sleep(0.002)
        code, _, raw = _req(s, "POST", "/v2/model/qwen3-4b/predict",
                            {"input": {"text": "late", "max_new_tokens": 2},
                             "deadline_ms": 1})
        for t in hold:
            t.join(timeout=60)
        assert code == 504
        assert json.loads(raw)["error"]["code"] == "DEADLINE_EXCEEDED"
        assert svc.stats()["shed"] == 1


def test_metrics_endpoint_same_series_as_jax(servers):
    """After the same requests, both servers' /v2/metrics carry the same
    counter keys and values and the same series names (timings aside)."""
    outs = []
    for s in servers:
        assert _req(s, "POST", "/v2/model/qwen3-4b/deploy",
                    {"paged": True, "prefix_cache": True,
                     "page_size": 16})[0] == 200
        for i in range(3):
            _req(s, "POST", "/v2/model/qwen3-4b/predict",
                 {"input": {"text": "shared words here", "max_new_tokens":
                            3 + i}, "priority": "interactive"})
        _, hdrs, raw = _req(s, "GET", "/v2/metrics?format=prometheus")
        assert hdrs["Content-Type"].startswith("text/plain")
        _, _, js = _req(s, "GET", "/v2/metrics")
        outs.append((raw.decode(), json.loads(js)["metrics"]))
    (jtext, jm), (ttext, tm) = outs

    def names(text):
        return sorted({line.split("{")[0].split(" ")[0]
                       for line in text.splitlines()
                       if line and not line.startswith("#")})
    assert names(ttext) == names(jtext)
    assert set(tm["histograms"]) == set(jm["histograms"])
    assert set(tm["gauges"]) == set(jm["gauges"])
    for k in ('max_generated_tokens_total{model="qwen3-4b"}',
              'max_requests_total{class="interactive",model="qwen3-4b",'
              'outcome="ok"}'):
        assert tm["counters"][k] == jm["counters"][k]
    svc = servers[1].manager.get("qwen3-4b").service
    kv = svc.stats()["kv_cache"]
    assert tm["gauges"]['max_kv_pool_blocks_in_use{model="qwen3-4b"}'] \
        == kv["blocks_in_use"]
    assert "tokens_per_s" in tm["derived"]
