"""The port's HTTP front against the JAX package's, on the CPU.

Both ``MAXServer``s listen on ``127.0.0.1:0`` with reduced ``qwen3-4b``
(max_seq 64, the JAX package's seed-0 weights bridged into the port), and
get the same v1 and v2 requests: the same statuses and the same envelopes,
apart from timing fields (``latency_ms``, ``uptime_s``,
``mean_latency_ms``), the server's name and ``framework``. The port's route
table is the JAX table, ``swagger.json`` covers every route it serves, the
QoS, sync, trace, ``faults`` and ``brownout`` fields are served (a bad
``faults`` or ``brownout`` spec answers 400 as on the JAX server and
leaves the deployment untouched), and a field of a still unported feature
(replicas, mesh slices) answers 501 ``NOT_IMPLEMENTED`` without touching
the deployment.
"""

import json
import threading
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
from repro.core.api import build_router as jax_build_router  # noqa: E402
from repro.core.registry import ModelRegistry  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import CONFIGS as PORT_CONFIGS  # noqa: E402
from repro_torch.core.api import (  # noqa: E402
    UNPORTED_DEPLOY_FIELDS, UNPORTED_PREDICT_FIELDS, MAXServer, build_router)

BUILD_KW = {"max_seq": 64, "max_batch": 4}
SERVICE_KW = {"batch_window_s": 0.15}
TIMING = ("latency_ms", "uptime_s", "mean_latency_ms")
# the JAX routes the port serves: every one
PORTED_V2 = {("GET", "/v2/models"),
             ("POST", "/v2/model/{model_id}/predict"),
             ("POST", "/v2/model/{model_id}/predict_batch"),
             ("POST", "/v2/model/{model_id}/stream"),
             ("POST", "/v2/model/{model_id}/jobs"),
             ("GET", "/v2/jobs/{job_id}"),
             ("GET", "/v2/jobs/{job_id}/events"),
             ("DELETE", "/v2/jobs/{job_id}"),
             ("GET", "/v2/jobs/{job_id}/trace"),
             ("GET", "/v2/trace/export"),
             ("POST", "/v2/model/{model_id}/deploy"),
             ("DELETE", "/v2/model/{model_id}"),
             ("GET", "/v2/model/{model_id}/stats"),
             ("GET", "/v2/metrics"),
             ("GET", "/v2/health"),
             ("GET", "/v2/routes")}


@pytest.fixture(scope="module")
def servers():
    reg = ModelRegistry()
    for name in PORT_CONFIGS:           # the assets the port serves
        reg.register(JAX_EXCHANGE.get(name))
    jparams = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"])).init(
        jax.random.PRNGKey(0))      # what the JAX asset builds at seed 0
    params = jax.tree_util.tree_map(np.asarray, jparams)
    with JaxServer(registry=reg, build_kw=BUILD_KW,
                   service_kw=SERVICE_KW) as js, \
            MAXServer(build_kw={**BUILD_KW, "device": "cpu",
                                "params": params},
                      service_kw=SERVICE_KW) as ts:
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


def _norm(x):
    """Drop timing fields; name the two frameworks alike."""
    if isinstance(x, dict):
        out = {k: _norm(v) for k, v in x.items() if k not in TIMING}
        if "framework" in out:
            out["framework"] = "*"
        if str(out.get("name", "")).startswith("Model Asset eXchange"):
            out["name"] = "*"
        return out
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


def _both(servers, method, path, payload=None):
    (jc, jb), (tc, tb) = (_req(s, method, path, payload) for s in servers)
    assert tc == jc, (path, jb, tb)
    return _norm(jb), _norm(tb)


TEXT = {"text": "a shared preamble, long enough for pages", "max_new_tokens": 6}

# (method, path, body) in order: the first deploys, the rest use it
CASES = [
    ("GET", "/", None),
    ("GET", "/v1", None),
    ("GET", "/models", None),
    ("GET", "/v1/models", None),
    ("GET", "/model/qwen3-4b/metadata", None),
    ("GET", "/model/nope/metadata", None),
    ("POST", "/v2/model/qwen3-4b/deploy", {"paged": True,
                                           "prefix_cache": True}),
    ("POST", "/v2/model/qwen3-4b/predict", {"input": TEXT}),
    ("POST", "/v2/model/qwen3-4b/predict", {"input": TEXT}),   # warm
    ("POST", "/model/qwen3-4b/predict", {"input": TEXT}),
    ("POST", "/v1/model/qwen3-4b/predict", {"input": "hi"}),
    ("POST", "/v2/model/qwen3-4b/predict_batch",
     {"inputs": ["a", {"text": "b", "max_new_tokens": 3}, {"nope": 1}]}),
    ("GET", "/model/qwen3-4b/labels", None),
    ("GET", "/health", None),
    ("GET", "/v2/models", None),
    ("POST", "/model/qwen3-4b/predict", {}),
    ("POST", "/model/qwen3-4b/predict", {"input": {"no_text": 1}}),
    ("POST", "/v2/model/qwen3-4b/predict", {"input": None}),
    ("POST", "/v2/model/qwen3-4b/predict", {"text": "unwrapped"}),
    ("POST", "/v2/model/qwen3-4b/predict_batch", {"inputs": []}),
    ("POST", "/v2/model/nope/predict", {"input": "x"}),
    ("POST", "/model/nope/predict", {"input": "x"}),
    ("GET", "/v2/model/qwen3-4b/predict", None),
    ("DELETE", "/models", None),
    ("GET", "/v2/nope", None),
    ("GET", "/nope", None),
    ("POST", "/v2/model/qwen3-4b/deploy", {"paged": "yes"}),
    ("POST", "/v2/model/qwen3-4b/deploy", {"page_size": 0}),
    ("POST", "/v2/model/qwen3-4b/deploy", {"page_size": 24}),
    ("POST", "/v2/model/qwen3-4b/deploy", {"prefix_cache": False,
                                           "prefix_cache_pages": 4}),
    ("POST", "/v2/model/qwen3-4b/deploy", {"service": "turbo"}),
    ("POST", "/v2/model/nope/deploy", {}),
    ("DELETE", "/v2/model/nope", None),
]


def test_same_requests_same_envelopes(servers):
    for method, path, body in CASES:
        jb, tb = _both(servers, method, path, body)
        assert tb == jb, (method, path)


def test_stats_report_the_same_kv_and_prefix_blocks(servers):
    """After the same requests, the deployments' KV pool and prefix-cache
    accounting agree, and the port's stats carry the JAX fields it
    serves."""
    jb, tb = _both(servers, "GET", "/v2/model/qwen3-4b/stats")
    js, ts = jb["service"], tb["service"]
    for key in ("kv_cache", "prefix_cache", "submitted", "completed",
                "rejected", "pool_exhausted", "cache_overflows",
                "emitted_tokens", "decode_chunk", "engine_max_batch"):
        assert ts[key] == js[key], key
    assert ts["kv_cache"]["paged"] and ts["prefix_cache"]["hit_tokens"] > 0


def test_concurrent_predicts_share_decode_batches(servers):
    _, ts = servers
    assert _req(ts, "POST", "/v2/model/qwen3-4b/deploy",
                {"paged": True, "prefix_cache": True})[0] == 200
    outs = [None] * 4
    gate = threading.Barrier(4)

    def go(i):
        gate.wait(timeout=30)
        outs[i] = _req(ts, "POST", "/v2/model/qwen3-4b/predict",
                       {"input": {"text": f"{TEXT['text']} {i}",
                                  "max_new_tokens": 8}})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(o is not None and o[0] == 200 for o in outs)
    code, stats = _req(ts, "GET", "/v2/model/qwen3-4b/stats")
    svc = stats["service"]
    assert svc["max_batch_seen"] >= 2 and svc["mean_batch_size"] > 1
    assert svc["prefix_cache"]["hit_tokens"] > 0
    dep = ts.manager.get("qwen3-4b")
    dep.wrapper.engine.check_pool_invariants()


def test_route_table_is_the_ported_subset_of_jax():
    def rows(router):
        return [(r["method"], r["path"], r["version"], r["media"])
                for r in router.table()]
    want = [r for r in rows(jax_build_router())
            if r[2] == "v1" or (r[0], r[1]) in PORTED_V2]
    assert rows(build_router()) == want
    assert {(m, p) for m, p, v, _ in want if v == "v2"} == PORTED_V2
    assert [r for r in rows(jax_build_router()) if r not in want] == []
    assert UNPORTED_PREDICT_FIELDS == ()
    assert set(UNPORTED_DEPLOY_FIELDS) == {"replicas", "mesh_slice"}


def test_routes_endpoint_and_swagger_cover_exactly_what_is_served(servers):
    _, ts = servers
    code, body = _req(ts, "GET", "/v2/routes")
    assert code == 200 and body["routes"] == build_router().table()
    code, spec = _req(ts, "GET", "/swagger.json")
    assert code == 200 and spec["openapi"].startswith("3.")
    routed = {(r["method"].lower(), r["path"]) for r in body["routes"]}
    per_asset = {pair for name in PORT_CONFIGS
                 for pair in (("post", f"/model/{name}/predict"),
                              ("get", f"/model/{name}/metadata"))}
    documented = {(m, p) for p, ops in spec["paths"].items() for m in ops}
    assert documented == routed | per_asset
    for method, path in routed:     # every documented route dispatches
        route, _, _ = ts.router.dispatch(method.upper(),
                                         path.replace("{model_id}", "x"))
        assert route is not None and route.template == path


@pytest.mark.parametrize("path,body,field", [
    ("/v2/model/qwen3-4b/deploy", {"replicas": 2}, "replicas"),
    ("/v2/model/qwen3-4b/deploy", {"mesh_slice": "auto"}, "mesh_slice"),
])
def test_unported_fields_answer_501_and_change_nothing(servers, path, body,
                                                       field):
    _, ts = servers
    assert _req(ts, "POST", "/v2/model/qwen3-4b/deploy", {})[0] == 200
    dep = ts.manager.get("qwen3-4b")
    stats0 = _req(ts, "GET", "/v2/model/qwen3-4b/stats")[1]["service"]
    code, env = _req(ts, "POST", path, body)
    assert code == 501
    assert env["status"] == "error"
    assert env["error"]["code"] == "NOT_IMPLEMENTED"
    assert field in env["error"]["message"]
    assert ts.manager.get("qwen3-4b") is dep       # not redeployed
    stats1 = _req(ts, "GET", "/v2/model/qwen3-4b/stats")[1]["service"]
    assert stats1["submitted"] == stats0["submitted"]


@pytest.mark.parametrize("body", [
    {"faults": {"chunk_rate": 2.0}},
    {"faults": {"wat": 1}},
    {"faults": {"script": [{"tick": 0, "site": "nope"}]}},
    {"faults": [{"chunk_rate": 0.1}]},          # per replica: no replicas
    {"faults": "chaos"},
    {"brownout": {"queue_soft": -1}},
    {"brownout": {"nope": 1}},
    {"brownout": "soft"},
], ids=["rate", "key", "site", "list", "type", "b-value", "b-key", "b-type"])
def test_bad_robustness_knobs_answer_400_and_change_nothing(servers, body):
    """A bad ``faults`` or ``brownout`` spec answers the JAX server's 400
    ``INVALID_INPUT``, validated before any teardown."""
    _both(servers, "POST", "/v2/model/qwen3-4b/deploy", {})
    _, ts = servers
    dep = ts.manager.get("qwen3-4b")
    stats0 = _req(ts, "GET", "/v2/model/qwen3-4b/stats")[1]["service"]
    jb, tb = _both(servers, "POST", "/v2/model/qwen3-4b/deploy", body)
    assert tb == jb
    assert tb["error"]["code"] == "INVALID_INPUT"
    assert next(iter(body)) in tb["error"]["message"]
    assert ts.manager.get("qwen3-4b") is dep       # not redeployed
    stats1 = _req(ts, "GET", "/v2/model/qwen3-4b/stats")[1]["service"]
    assert stats1["submitted"] == stats0["submitted"]


@pytest.mark.parametrize("path,body,field", [
    ("/v2/model/qwen3-4b/predict", {"input": "x", "priority": "batch"},
     "priority"),
    ("/v2/model/qwen3-4b/predict", {"input": "x", "client": "c"}, "client"),
    ("/v2/model/qwen3-4b/predict", {"input": "x", "deadline_ms": 50000},
     "deadline_ms"),
    ("/v2/model/qwen3-4b/predict_batch", {"inputs": ["x"],
                                          "priority": "interactive"},
     "priority"),
    ("/v2/model/qwen3-4b/deploy", {"qos": {"policy": "fifo"}}, "qos"),
    ("/v2/model/qwen3-4b/deploy", {"trace": True}, "trace"),
    ("/v2/model/qwen3-4b/deploy", {"trace_buffer": 8}, "trace_buffer"),
    ("/v2/model/qwen3-4b/deploy", {"slow_trace_ms": 5}, "slow_trace_ms"),
    ("/v2/model/qwen3-4b/deploy", {"service": "sync", "paged": True},
     "sync"),
    ("/v2/model/qwen3-4b/deploy", {"faults": {"chunk_rate": 0.0}},
     "faults"),
    ("/v2/model/qwen3-4b/deploy", {"brownout": {"retry_after_s": 2.0}},
     "brownout"),
])
def test_formerly_unported_fields_are_served_as_jax(servers, path, body,
                                                    field):
    """The QoS, trace, sync and robustness fields that answered 501 before
    now answer as the JAX server does."""
    _both(servers, "POST", "/v2/model/qwen3-4b/deploy", {})
    jb, tb = _both(servers, "POST", path, body)
    assert tb.get("status") in ("ok", "partial"), (field, tb)
    if path.endswith("/deploy"):
        assert tb == jb
        if field == "sync":
            assert tb["service"] == "sync" and tb["kv_cache"]["paged"]
    else:
        assert _norm(tb) == _norm(jb)


def test_deploy_undeploy_lifecycle_matches_jax(servers):
    for method, path, body in [
            ("POST", "/v2/model/qwen3-4b/deploy", {"paged": True,
                                                   "page_size": 8,
                                                   "kv_pool_blocks": 12}),
            ("DELETE", "/v2/model/qwen3-4b", None),
            ("DELETE", "/v2/model/qwen3-4b", None),
            ("GET", "/v2/models", None),
            ("POST", "/model/qwen3-4b/deploy", {}),
            ("GET", "/", None)]:
        jb, tb = _both(servers, method, path, body)
        assert tb == jb, (method, path)


def test_default_build_device_is_cuda():
    """Without ``device`` in ``build_kw`` a deploy builds on the GPU, and
    so raises without one (no silent CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    server = MAXServer(build_kw=BUILD_KW)
    try:
        resp = server.dispatch("POST", "/v2/model/qwen3-4b/predict",
                               {"input": "hi"})
        assert resp.status == 500
        assert "CUDA is not available" in resp.body["error"]["message"]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            server.manager.deploy("qwen3-4b", **BUILD_KW)
    finally:
        server.stop()
