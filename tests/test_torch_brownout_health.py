"""The port's brownout degradation and ``GET /v2/health`` against the JAX
package's, on the CPU (after ``tests/test_brownout_health.py``).

- ``BrownoutController`` is a copy: the same config and the same event
  sequence (explicit clock) walk the same states, shed with the same
  errors and clamp alike; a bad config is refused with the same message.
- ``BatchedService`` on reduced ``qwen3-4b`` (the JAX package's seed-0
  weights bridged into the port): SOFT clamps ``max_new_tokens`` to the
  JAX service's clamped tokens and sheds ``best_effort`` as ``DEGRADED``.
- Over HTTP, both servers deployed with the same ``brownout`` and QoS
  knobs: ``/v2/health`` answers the same status and body when ready, with
  a dead worker (503) and in HARD (503 with ``Retry-After``; a predict
  answers ``CIRCUIT_OPEN``), and 200 again once the force is released or
  the worker is respawned; the sync service's health; the same brownout
  series in ``/v2/metrics``; an undeploy racing in-flight jobs leaks no
  page.

Tokens and bodies are compared exactly (timing fields aside).
"""

import json
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
from repro.core.service import BatchedService as JaxBatchedService  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving import qos as jax_qos  # noqa: E402
from repro_torch.configs import CONFIGS as PORT_CONFIGS  # noqa: E402
from repro_torch.core.api import MAXServer  # noqa: E402
from repro_torch.core.assets import EXCHANGE  # noqa: E402
from repro_torch.core.deployment import DeploymentManager  # noqa: E402
from repro_torch.core.service import BatchedService  # noqa: E402
from repro_torch.serving import faults as port_faults  # noqa: E402
from repro_torch.serving import qos as port_qos  # noqa: E402

BUILD_KW = {"max_seq": 64, "max_batch": 4}
# a stall budget no CPU tick reaches (a JAX tick that compiles could pass
# the default 5 s and change a health body)
SERVICE_KW = {"batch_window_s": 0.0, "stall_budget_s": 600.0}


# -- controller (explicit clock) ---------------------------------------------

# (method, args, kwargs) sequences applied to both controllers
SEQUENCES = {
    "escalate-cool": ({"escalate_s": 0.1, "cool_s": 1.0}, [
        ("observe", (0.0,), {"now": 0.0}), ("observe", (1.0,), {"now": 0.2}),
        ("observe", (1.0,), {"now": 0.35}), ("observe", (2.0,), {"now": 0.4}),
        ("observe", (2.0,), {"now": 0.55}), ("observe", (0.0,), {"now": 0.6}),
        ("observe", (0.0,), {"now": 1.7}), ("observe", (0.0,), {"now": 2.8})]),
    "events": ({"fault_soft": 3, "escalate_s": 0.1, "window_s": 2.0}, [
        ("note", ("fault", 3), {"now": 0.0}),
        ("observe", (0.0,), {"now": 0.05}), ("observe", (0.0,), {"now": 0.2}),
        ("note", ("pool_exhausted", 8), {"now": 0.3}),
        ("observe", (0.0,), {"now": 0.35}), ("observe", (0.0,), {"now": 0.5}),
        ("observe", (0.0,), {"now": 3.0}), ("observe", (0.0,), {"now": 4.1}),
        ("note", ("stall",), {"now": 4.2}),
        ("observe", (0.0,), {"now": 4.25}), ("observe", (0.0,), {"now": 5.0}),
        ("observe", (0.0,), {"now": 8.0}), ("observe", (0.0,), {"now": 9.5})]),
    "forced": ({"queue_soft": 0.5, "queue_hard": 1.0, "escalate_s": 0.05}, [
        ("observe", (0.6,), {"now": 0.0}), ("observe", (0.6,), {"now": 0.1}),
        ("force", ("hard",), {}), ("observe", (0.0,), {"now": 0.2}),
        ("force", (None,), {}), ("observe", (0.0,), {"now": 0.3}),
        ("observe", (1.2,), {"now": 2.0}), ("observe", (1.2,), {"now": 2.1}),
        ("force", ("normal",), {}), ("force", (None,), {}),
        ("observe", (0.0,), {"now": 2.2})]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_controller_walks_the_jax_states(name):
    cfg, ops = SEQUENCES[name]
    walks, stats = [], []
    for mod in (jax_faults, port_faults):
        ctl = mod.BrownoutController(cfg)
        walks.append([(op, getattr(ctl, op)(*a, **kw), ctl.state)
                      for op, a, kw in ops])
        stats.append(ctl.stats())
    assert walks[1] == walks[0]
    assert stats[1] == stats[0]
    assert len({s for _, _, s in walks[1]}) >= 2      # it moved


def test_soft_sheds_best_effort_and_clamps_budget_like_jax():
    out = []
    for mod, qos in ((jax_faults, jax_qos), (port_faults, port_qos)):
        c = mod.BrownoutController({"clamp_tokens": 32,
                                    "retry_after_s": 2.5})
        c.force("soft")
        c.admit("interactive")
        with pytest.raises(qos.Degraded) as soft:
            c.admit("best_effort")
        clamps = (c.clamp(100), c.clamp(8), c.clamp(None))
        c.force("hard")
        with pytest.raises(qos.CircuitOpen) as hard:
            c.admit("interactive")
        out.append((str(soft.value), soft.value.retry_after_s,
                    soft.value.code, clamps, str(hard.value),
                    hard.value.retry_after_s, hard.value.code, c.clamp(100),
                    c.stats()))
    assert out[1] == out[0]
    assert out[1][3] == (32, 8, None) and out[1][-1]["shed"] == 2


@pytest.mark.parametrize("obj", [
    {"queue_soft": 0}, {"exhaust_soft": 0}, {"clamp_tokens": 0},
    {"clamp_tokens": True}, {"nope": 1}, "soft",
], ids=["queue", "exhaust", "clamp", "clamp-bool", "key", "type"])
def test_brownout_config_validation_equals_jax(obj):
    with pytest.raises(ValueError) as want:
        jax_faults.BrownoutConfig.from_json(obj)
    with pytest.raises(ValueError) as got:
        port_faults.BrownoutConfig.from_json(obj)
    assert str(got.value) == str(want.value)


# -- service-level degradation -----------------------------------------------

@pytest.fixture(scope="module")
def jax_wrapper():
    return JAX_EXCHANGE.get("qwen3-4b").build(**BUILD_KW)


def test_service_soft_brownout_clamps_and_sheds(jax_wrapper):
    text = "brownout clamp"
    plain = JaxBatchedService(jax_wrapper, batch_window_s=0.0)
    try:
        short = plain.predict({"text": text, "max_new_tokens": 4})
    finally:
        plain.close()
    params = jax.tree_util.tree_map(np.asarray, jax_wrapper.params)
    wrapper = EXCHANGE.get("qwen3-4b").build(device="cpu", params=params,
                                             **BUILD_KW)
    svc = BatchedService(wrapper, batch_window_s=0.0,
                         brownout={"clamp_tokens": 4, "retry_after_s": 2.0})
    try:
        svc._brownout.force("soft")
        env = svc.predict({"text": text, "max_new_tokens": 12})
        assert env["status"] == "ok"
        assert env["predictions"] == short["predictions"]
        shed = svc.predict({"text": text, "max_new_tokens": 4},
                           {"priority": "best_effort"})
        assert shed["status"] == "error" and shed["code"] == "DEGRADED"
        assert shed["retry_after_s"] == 2.0
        assert svc.stats()["robustness"]["brownout"]["shed"] == 1
        svc._brownout.force(None)
    finally:
        svc.close()


# -- HTTP: /v2/health and Retry-After, on both servers -----------------------

DEPLOY = {"service": "batched", "brownout": {"retry_after_s": 2.0},
          "qos": {"rate": 0.001, "burst": 1.0}}


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


def _req(server, method, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(server.url + path, data,
                                 {"Content-Type": "application/json"},
                                 method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _both(servers, method, path, payload=None):
    """Both servers' (status, body, Retry-After); the same status."""
    (jc, jb, jh), (tc, tb, th) = (_req(s, method, path, payload)
                                  for s in servers)
    assert tc == jc, (path, jb, tb)
    return (jc, jb, jh.get("Retry-After")), (tc, tb, th.get("Retry-After"))


def _deploy(servers, body=DEPLOY):
    (jc, jb, _), (tc, tb, _) = _both(servers, "POST",
                                     "/v2/model/qwen3-4b/deploy", body)
    assert tc == 200, tb
    return [s.manager.get("qwen3-4b").service for s in servers]


def _predictions(body):
    return [{k: v for k, v in p.items() if k != "ttft_ms"}
            for p in body["predictions"]]


def test_health_reports_ready_like_jax(servers):
    _deploy(servers)
    want, got = _both(servers, "GET", "/v2/health")
    assert got == want
    code, body, _ = got
    assert code == 200 and body["status"] == "ok" and body["ready"]
    dep = body["deployments"]["qwen3-4b"]
    assert dep["degradation"] == "normal" and dep["worker_alive"]


def test_circuit_open_is_503_with_retry_after_like_jax(servers):
    ctls = [svc._brownout for svc in _deploy(servers)]
    for c in ctls:
        c.force("hard")
    try:
        want, got = _both(servers, "POST", "/v2/model/qwen3-4b/predict",
                          {"input": {"text": "hi", "max_new_tokens": 2},
                           "client": "hard-c"})
        assert got == want
        code, body, after = got
        assert code == 503 and body["error"]["code"] == "CIRCUIT_OPEN"
        assert body["error"]["retry_after_s"] == 2.0 and after == "2"
        want, got = _both(servers, "GET", "/v2/health")
        assert got == want
        code, body, after = got
        assert code == 503 and not body["ready"] and body["degraded"]
        assert after == "1"
        assert body["deployments"]["qwen3-4b"]["degradation"] == "hard"
    finally:
        for c in ctls:
            c.force("normal")
            c.force(None)
    want, got = _both(servers, "GET", "/v2/health")
    assert got == want and got[0] == 200


def test_soft_sheds_best_effort_over_http_like_jax(servers):
    ctls = [svc._brownout for svc in _deploy(servers)]
    for c in ctls:
        c.force("soft")
    try:
        want, got = _both(servers, "POST", "/v2/model/qwen3-4b/predict",
                          {"input": {"text": "be", "max_new_tokens": 2},
                           "priority": "best_effort", "client": "be-c"})
        assert got == want
        assert got[0] == 503 and got[1]["error"]["code"] == "DEGRADED"
        want, got = _both(servers, "GET", "/v2/health")
        assert got == want and got[0] == 200      # SOFT still serves
        assert got[1]["degraded"]
    finally:
        for c in ctls:
            c.force(None)


def test_rate_limit_429_carries_retry_after(servers):
    _deploy(servers)
    inp = {"input": {"text": "rl", "max_new_tokens": 2}, "client": "rl-c"}
    want, got = _both(servers, "POST", "/v2/model/qwen3-4b/predict", inp)
    assert got[0] == 200
    assert _predictions(got[1]) == _predictions(want[1])
    want, got = _both(servers, "POST", "/v2/model/qwen3-4b/predict", inp)
    assert got[0] == 429 and got[1]["error"]["code"] == "RATE_LIMITED"
    assert got[2] is not None and int(got[2]) >= 1


def test_brownout_series_equal_jax(servers):
    for c in [svc._brownout for svc in _deploy(servers)]:
        c.force("hard")
        c.force(None)
    _both(servers, "POST", "/v2/model/qwen3-4b/predict",
          {"input": {"text": "x", "max_new_tokens": 1}, "client": "m-c"})

    def series(server):
        with urllib.request.urlopen(
                server.url + "/v2/metrics?format=prometheus") as r:
            text = r.read().decode()
        return sorted(line.split(" ")[0] for line in text.splitlines()
                      if line.startswith(("max_brownout", "max_engine",
                                          "max_retries", "max_worker",
                                          "max_tick")))
    assert series(servers[1]) == series(servers[0])
    assert any(s.startswith("max_brownout_state") for s in
               series(servers[1]))


def test_dead_worker_health_like_jax(servers):
    """A kill at the first chunk with the watchdog's respawn held: both
    servers answer 503 with the same body; released, the worker respawns,
    health answers 200 again and the job, retried (no token had reached
    its buffer), gives the same tokens on both."""
    svcs = _deploy(servers, {"service": "batched",
                             "faults": {"kill_rate": 1.0, "max_faults": 1}})
    for svc in svcs:
        svc._respawn_worker = lambda: None        # hold the watchdog
    jids = []
    for s in servers:
        code, body, _ = _req(s, "POST", "/v2/model/qwen3-4b/jobs",
                             {"input": {"text": "dead", "max_new_tokens": 5}})
        assert code == 202
        jids.append(body["job"]["id"])
    deadline = time.monotonic() + 60
    while any(svc._thread.is_alive() for svc in svcs):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    want, got = _both(servers, "GET", "/v2/health")
    assert got == want
    code, body, after = got
    dep = body["deployments"]["qwen3-4b"]
    assert code == 503 and after == "1" and not body["ready"]
    assert not dep["worker_alive"] and dep["worker_restarts"] == 0
    for svc in svcs:
        del svc._respawn_worker                   # the watchdog respawns
    results = []
    for s, jid in zip(servers, jids):
        deadline = time.monotonic() + 60
        while True:
            job = _req(s, "GET", f"/v2/jobs/{jid}")[1]["job"]
            if job["state"] not in ("queued", "running"):
                break
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert job["state"] == "done", job
        results.append(_predictions(job["result"]))
    assert results[1] == results[0]
    want, got = _both(servers, "GET", "/v2/health")
    assert got == want and got[0] == 200
    dep = got[1]["deployments"]["qwen3-4b"]
    assert dep["worker_restarts"] == 1 and dep["engine_faults"] == 1
    assert [svc.stats()["robustness"]["retries"] for svc in svcs] == [1, 1]


def test_sync_service_health_like_jax(servers):
    _deploy(servers, {"service": "sync"})
    want, got = _both(servers, "GET", "/v2/health")
    assert got == want and got[0] == 200
    assert got[1]["deployments"]["qwen3-4b"] == {
        "live": True, "ready": True, "degradation": "normal"}


# -- deploy/undeploy racing in-flight jobs -----------------------------------

def test_undeploy_races_inflight_jobs_without_leaks(jax_wrapper):
    params = jax.tree_util.tree_map(np.asarray, jax_wrapper.params)
    mgr = DeploymentManager(service_mode="batched",
                            service_kw={"batch_window_s": 0.0})
    dep = mgr.deploy("qwen3-4b", paged=True, page_size=16, device="cpu",
                     params=params, **BUILD_KW)
    svc, engine = dep.service, dep.wrapper.engine
    jobs = [svc.submit_job({"text": f"race {i}", "max_new_tokens": 16})
            for i in range(6)]
    undone = threading.Thread(target=mgr.undeploy, args=("qwen3-4b",))
    time.sleep(0.05)
    undone.start()
    undone.join(timeout=30)
    assert not undone.is_alive()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        states = [svc.get_job(j.id).state for j in jobs]
        if all(s in ("done", "error", "cancelled") for s in states):
            break
        time.sleep(0.02)
    else:
        raise AssertionError(f"jobs stuck after undeploy: {states}")
    for j in jobs:
        got = svc.get_job(j.id)
        if got.state == "error":
            assert got.error
    assert not svc._watchdog_thread.is_alive()
    engine.check_pool_invariants()
    dep2 = mgr.deploy("qwen3-4b", device="cpu", params=params, **BUILD_KW)
    assert dep2.predict({"text": "after race",
                         "max_new_tokens": 4})["status"] == "ok"
    mgr.undeploy("qwen3-4b")


@pytest.mark.parametrize("how", ["undeploy", "redeploy"])
def test_undeploy_frees_the_deployment_at_once(jax_wrapper, how):
    """Finished requests hold a closed service in reference cycles; the
    undeploy collects them, so the engine (on the card: its weights and
    KV cache) is gone before a redeploy builds the next one."""
    import weakref
    params = jax.tree_util.tree_map(np.asarray, jax_wrapper.params)
    mgr = DeploymentManager(service_mode="batched",
                            service_kw={"batch_window_s": 0.0})
    kw = dict(paged=True, page_size=16, prefix_cache=True, device="cpu",
              params=params, **BUILD_KW)
    dep = mgr.deploy("qwen3-4b", **kw)
    for i in range(3):
        assert dep.predict({"text": f"cycle {i}",
                            "max_new_tokens": 3})["status"] == "ok"
    job = dep.service.submit_job({"text": "job", "max_new_tokens": 3})
    deadline = time.monotonic() + 30
    while dep.service.get_job(job.id).state != "done":
        assert time.monotonic() < deadline
        time.sleep(0.01)
    engine = weakref.ref(dep.wrapper.engine)
    del dep, job
    if how == "undeploy":
        assert mgr.undeploy("qwen3-4b")
        assert engine() is None
    else:
        built = []
        registry_get = mgr.registry.get

        def get(asset_id):          # the build starts with the old gone
            built.append(engine() is None)
            return registry_get(asset_id)
        mgr.registry.get = get
        try:
            mgr.deploy("qwen3-4b", force=True, **kw)
        finally:
            del mgr.registry.get
        assert built == [True]
        mgr.undeploy("qwen3-4b")
