"""The port's fault plane, quarantine, safe retry, watchdog and engine
rebuild against the JAX package's, on the CPU (after
``tests/test_faults.py``).

- ``serving/faults.py`` is a copy: the same spec and seed fire the same
  faults (site, tick, victim slot) in both planes, and a bad spec is
  refused with the same message.
- The scheduler on reduced ``qwen3-4b`` with the JAX package's seed-0
  weights bridged into the port (paged, 3 slots): a scripted admission
  fault and a scoped chunk fault retire only their victim, seeded chunk
  faults retire the same requests at the same ticks, and the co-batch's
  greedy tokens equal the JAX scheduler's; an unarmed plane changes no
  token and no host read; the ``ENGINE_FAULT`` messages are the JAX ones.
- ``BatchedService`` (paged, prefix-cached, as on the card): a faulted
  greedy request that delivered no token is retried to the JAX service's
  fault-free tokens; a stream that faults after its first token ends in
  a terminal ``error`` event; a killed worker is respawned and the
  recovery runs on the new worker thread, never on the watchdog's;
  repeated faults rebuild the engine, and ``engine.reset()`` restores
  the pool and the tokens; a stall is flagged; a recovery that fails
  holds readiness down.

Tokens are compared exactly; there is no float here.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import reduce_for_smoke  # noqa: E402
from repro.core.assets import EXCHANGE as JAX_EXCHANGE  # noqa: E402
from repro.core.service import BatchedService as JaxBatchedService  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serving import GenerationEngine as JaxEngine  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.core.assets import EXCHANGE  # noqa: E402
from repro_torch.core.service import BatchedService  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import to_torch_params  # noqa: E402
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine  # noqa: E402
from repro_torch.serving import faults as port_faults  # noqa: E402
from repro_torch.serving.faults import (  # noqa: E402
    FaultPlane, FaultSpec, InjectedFault, WorkerKill)

BUILD_KW = {"max_seq": 64, "max_batch": 4}


# -- spec & plane ------------------------------------------------------------

@pytest.mark.parametrize("obj", [
    {"chunk_rate": 2.0}, {"wat": 1}, {"script": [{"tick": 0, "site": "no"}]},
    {"seed": "seven"}, {"stall_s": 0}, {"max_faults": -1},
    {"script": [{"tick": 1, "site": "chunk", "slot": True}]}, [1],
], ids=["rate", "key", "site", "seed", "stall", "budget", "slot", "type"])
def test_fault_spec_validation_equals_jax(obj):
    with pytest.raises(ValueError) as want:
        jax_faults.FaultSpec.from_json(obj)
    with pytest.raises(ValueError) as got:
        FaultSpec.from_json(obj)
    assert str(got.value) == str(want.value)


def test_fault_spec_armed_equals_jax():
    for obj in ({}, {"chunk_rate": 0.0}, {"chunk_rate": 0.5},
                {"script": [{"tick": 3, "site": "kill"}]},
                {"stall_rate": 0.1, "stall_s": 0.5, "seed": 4}):
        got, want = FaultSpec.from_json(obj), jax_faults.FaultSpec.from_json(obj)
        assert got.armed == want.armed
        assert got.__dict__ == want.__dict__


def _fire_schedule(mod, spec, ticks=80):
    """(tick, what) for every check an admission and a chunk check per
    tick give, and the plane's stats at the end."""
    plane = mod.FaultPlane(mod.FaultSpec.from_json(spec))
    fired = []
    for tick in range(ticks):
        try:
            plane.check_admission(tick)
        except mod.InjectedFault as e:
            fired.append((tick, e.site, e.slot, str(e)))
        try:
            plane.check_chunk(tick, [0, 2, 3])
        except mod.InjectedFault as e:
            fired.append((tick, e.site, e.slot, str(e)))
        except mod.WorkerKill as e:
            fired.append((tick, "kill", None, str(e)))
    return fired, plane.stats()


@pytest.mark.parametrize("spec", [
    {"chunk_rate": 0.3, "seed": 11},
    {"admission_rate": 0.2, "chunk_rate": 0.25, "stall_rate": 0.1,
     "stall_s": 0.0001, "kill_rate": 0.05, "seed": 3},
    {"chunk_rate": 1.0, "max_faults": 4, "seed": 9,
     "script": [{"tick": 2, "site": "chunk", "slot": 3},
                {"tick": 5, "site": "admission"},
                {"tick": 7, "site": "kill"}]},
], ids=["chunk", "mixed", "scripted"])
def test_fault_plane_fires_like_jax(spec):
    want = _fire_schedule(jax_faults, spec)
    got = _fire_schedule(port_faults, spec)
    assert got == want
    assert got[0]                       # the spec fired something
    assert _fire_schedule(jax_faults, spec) == want     # deterministic


def test_scripted_kill_and_max_faults():
    plane = FaultPlane(FaultSpec.from_json(
        {"script": [{"tick": 2, "site": "kill"}]}))
    plane.check_chunk(0, [0])
    plane.check_chunk(1, [0])
    with pytest.raises(WorkerKill):
        plane.check_chunk(2, [0])
    assert plane.stats() == {"armed": True, "script_pending": 0,
                             "fired": {"admission": 0, "chunk": 0,
                                       "stall": 0, "kill": 1}}
    capped = FaultPlane(FaultSpec.from_json(
        {"chunk_rate": 1.0, "max_faults": 2}))
    fired = 0
    for tick in range(10):
        try:
            capped.check_chunk(tick, [0])
        except InjectedFault:
            fired += 1
    assert fired == 2


# -- the scheduler against the JAX scheduler ---------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"]))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = to_torch_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(t_reduce(get_config("qwen3-4b"))), tparams


@pytest.fixture(scope="module")
def engines(models):
    jm, jparams, tm, tparams = models
    kw = dict(max_batch=3, max_seq=32, paged=True, page_size=8)
    return (JaxEngine(jm, jparams, **kw),
            GenerationEngine(tm, tparams, device="cpu", **kw))


def _run_both(engines, prompts, budget, faults=None):
    out = []
    for sched_cls, eng in zip((JaxScheduler, ContinuousBatchingScheduler),
                              engines):
        sched = sched_cls(eng, faults=faults)
        reqs = [sched.submit(p, max_new_tokens=budget) for p in prompts]
        stats = sched.run()
        eng.check_pool_invariants()
        out.append((reqs, stats, sched))
    return out


def _view(reqs):
    return [(r.output, r.error_code, r.error, r.admitted_at_tick,
             r.finished_at_tick) for r in reqs]


def test_admission_fault_retires_only_the_victim_like_jax(engines):
    prompts = [[256, 1 + i, 7] for i in range(3)]
    (jr, _, _), (base, _, _) = _run_both(engines, prompts, 4)
    (jf, js, _), (tr, ts, _) = _run_both(
        engines, prompts, 4,
        faults={"script": [{"tick": 0, "site": "admission"}]})
    assert _view(tr) == _view(jf)
    assert [r.output for r in base] == [r.output for r in jr]
    assert tr[0].error_code == "ENGINE_FAULT" and tr[0].output == []
    for got, want in zip(tr[1:], base[1:]):
        assert got.error_code is None and got.output == want.output
    assert ts.engine_faults == js.engine_faults == 1


def test_chunk_fault_quarantines_single_slot_like_jax(engines):
    prompts = [[256, 11 + i, 3, 5] for i in range(3)]
    (_, _, _), (base, _, _) = _run_both(engines, prompts, 8)
    (jf, js, _), (tr, ts, _) = _run_both(
        engines, prompts, 8,
        faults={"script": [{"tick": 1, "site": "chunk", "slot": 1}]})
    assert _view(tr) == _view(jf)
    assert tr[1].error_code == "ENGINE_FAULT" and len(tr[1].output) < 8
    for i in (0, 2):
        assert tr[i].error_code is None and tr[i].output == base[i].output
    assert ts.engine_faults == js.engine_faults == 1


def test_seeded_chunk_faults_retire_what_jax_retires(engines):
    """A seeded per-chunk rate over more requests than slots: the same
    victims at the same ticks, the survivors' tokens, the same counts."""
    prompts = [[256, 40 + i, 2 * i + 1] for i in range(7)]
    (jf, js, jsch), (tr, ts, tsch) = _run_both(
        engines, prompts, 6, faults={"chunk_rate": 0.3, "seed": 2})
    assert _view(tr) == _view(jf)
    assert ts.engine_faults == js.engine_faults > 0
    assert ts.completed == js.completed
    assert tsch.faults.stats() == jsch.faults.stats()
    assert tsch.fault_streak == jsch.fault_streak


def test_unarmed_plane_keeps_tokens_and_host_reads(engines):
    prompts = [[256, 21 + i] for i in range(3)]

    def run(faults):
        sched = ContinuousBatchingScheduler(engines[1], faults=faults)
        reqs = [sched.submit(p, max_new_tokens=6) for p in prompts]
        stats = sched.run()
        return [r.output for r in reqs], stats.host_reads, stats.ticks

    plain = run(None)
    assert run({"chunk_rate": 0.0}) == run(FaultSpec()) == plain
    assert plain[1] == plain[2]            # one read a tick
    (jr, _, _), _ = _run_both(engines, prompts, 6)
    assert plain[0] == [r.output for r in jr]


def test_quarantine_error_strings_match_jax(engines):
    """A real dispatch fault retires the co-batch with the JAX scheduler's
    message and site; a failed read too (the port reads firsts and the
    chunk in one transfer)."""
    prompts = [[256, 5], [256, 6, 7]]
    got = []
    for sched_cls, eng in zip((JaxScheduler, ContinuousBatchingScheduler),
                              engines):
        sched = sched_cls(eng)
        reqs = [sched.submit(p, max_new_tokens=5) for p in prompts]

        def boom(*a, **kw):
            raise RuntimeError("boom")
        eng.step_chunk = boom
        try:
            sched.tick()
        finally:
            del eng.step_chunk
        got.append([(r.error_code, r.error) for r in reqs])
        eng.check_pool_invariants()
        assert sched.fault_streak == 2
    assert got[1] == got[0]
    assert got[1][0] == ("ENGINE_FAULT",
                         "engine fault during chunk: chunk dispatch "
                         "failed: boom")
    sched = ContinuousBatchingScheduler(engines[1])
    req = sched.submit([256, 9], max_new_tokens=5)

    def bad_read(*a):
        raise RuntimeError("lost")
    sched._read = bad_read
    sched.tick()
    assert (req.error_code, req.error) == (
        "ENGINE_FAULT", "engine fault during chunk: chunk sync failed: lost")
    engines[1].check_pool_invariants()


def test_engine_reset_restores_pool_and_determinism(models):
    jm, jparams, tm, tparams = models
    kw = dict(max_batch=2, max_seq=32, paged=True, page_size=8,
              prefix_cache=True)
    eng = GenerationEngine(tm, tparams, device="cpu", **kw)

    def run(e, cls):
        sched = cls(e)
        reqs = [sched.submit([256, 1, 2, 3], max_new_tokens=5),
                sched.submit([256, 4, 5], max_new_tokens=5)]
        sched.run()
        return [r.output for r in reqs]

    before = run(eng, ContinuousBatchingScheduler)
    eng.insert_request([256, 7, 8, 9], 0)      # leave a seated slot behind
    eng.reset()
    eng.check_pool_invariants()
    assert eng.blocks_in_use() == 0
    assert eng.prefix_stats()["cached_pages"] == 0
    assert run(eng, ContinuousBatchingScheduler) == before
    assert before == run(JaxEngine(jm, jparams, **kw), JaxScheduler)
    eng.check_pool_invariants()


# -- the service -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_wrapper():
    return JAX_EXCHANGE.get("qwen3-4b").build(**BUILD_KW)


@pytest.fixture(scope="module")
def gen_wrapper(jax_wrapper):
    """The chip's main path: the paged pool with the prefix cache."""
    params = jax.tree_util.tree_map(np.asarray, jax_wrapper.params)
    return EXCHANGE.get("qwen3-4b").build(device="cpu", params=params,
                                          paged=True, page_size=16,
                                          prefix_cache=True, **BUILD_KW)


@pytest.fixture(scope="module")
def jax_free(jax_wrapper):
    """The JAX service's fault-free generated text of an input, cached."""
    seen = {}

    def get(inp):
        key = (inp["text"], inp["max_new_tokens"])
        if key not in seen:
            svc = JaxBatchedService(jax_wrapper, batch_window_s=0.0)
            try:
                env = svc.predict(inp)
            finally:
                svc.close()
            assert env["status"] == "ok", env
            seen[key] = env["predictions"][0]["generated_text"]
        return seen[key]
    return get


def _text(env):
    assert env["status"] == "ok", env
    return env["predictions"][0]["generated_text"]


def _wait_jobs(svc, jobs, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    terminal = ("done", "error", "cancelled")
    while time.monotonic() < deadline:
        if all(svc.get_job(j.id).state in terminal for j in jobs):
            return [svc.get_job(j.id) for j in jobs]
        time.sleep(0.02)
    raise AssertionError(
        f"jobs not terminal: {[svc.get_job(j.id).state for j in jobs]}")


def test_service_retries_fault_to_jax_fault_free_tokens(gen_wrapper,
                                                        jax_free):
    inputs = [{"text": f"retry {i}", "max_new_tokens": 6} for i in range(3)]
    svc = BatchedService(
        gen_wrapper, batch_window_s=0.0,
        faults={"script": [{"tick": 1, "site": "chunk"},
                           {"tick": 3, "site": "chunk"}]},
        max_retries=4, retry_backoff_s=0.01)
    try:
        got = [svc.predict(inp) for inp in inputs]
        rob = svc.stats()["robustness"]
        health = svc.health()
    finally:
        svc.close()
    assert [_text(g) for g in got] == [jax_free(i) for i in inputs]
    assert rob["engine_faults"] == 2 and rob["retries"] == 2
    assert rob["retry_pending"] == 0
    assert rob["fault_injection"]["fired"]["chunk"] == 2
    assert health["engine_faults"] == 2 and health["ready"]


def test_retry_exhaustion_surfaces_engine_fault(gen_wrapper):
    svc = BatchedService(gen_wrapper, batch_window_s=0.0,
                         faults={"chunk_rate": 1.0, "seed": 0},
                         max_retries=1, retry_backoff_s=0.01)
    try:
        env = svc.predict({"text": "doomed", "max_new_tokens": 4})
        rob = svc.stats()["robustness"]
    finally:
        svc.close()
    assert env["status"] == "error" and env["code"] == "ENGINE_FAULT"
    assert rob["retries"] == 1            # the first attempt and one retry
    assert rob["engine_faults"] >= 2


def test_stream_fault_after_tokens_gets_terminal_error_event(gen_wrapper,
                                                             jax_free):
    """A fault after tokens reached the stream closes it with a terminal
    ``ENGINE_FAULT`` event and no retry (a replay would duplicate what the
    client saw)."""
    inp = {"text": "stream fault", "max_new_tokens": 6}
    clean = BatchedService(gen_wrapper, batch_window_s=0.0)
    try:
        clean_toks = [t for ev in clean.predict_stream(inp)
                      if ev.event == "token" for t in ev.data["token_ids"]]
    finally:
        clean.close()
    assert len(clean_toks) == 6
    assert gen_wrapper.format_generation(clean_toks, 0)[0][
        "generated_text"] == jax_free(inp)
    svc = BatchedService(gen_wrapper, batch_window_s=0.0,
                         faults={"script": [{"tick": 1, "site": "chunk"}]},
                         max_retries=3, retry_backoff_s=0.01)
    try:
        events = list(svc.predict_stream(inp))
        rob = svc.stats()["robustness"]
    finally:
        svc.close()
    toks = [t for ev in events if ev.event == "token"
            for t in ev.data["token_ids"]]
    assert 0 < len(toks) < 6
    assert toks == clean_toks[:len(toks)]
    assert events[-1].event == "error"
    assert events[-1].data["code"] == "ENGINE_FAULT"
    assert not any(e.event == "done" for e in events)
    assert rob["retries"] == 0


def test_worker_kill_respawns_and_recovers_on_the_worker(gen_wrapper,
                                                         jax_free):
    """A scripted kill at tick 2: the watchdog starts a new worker, which
    quarantines the dead one's slots and resets the engine itself (the
    watchdog thread runs neither); queued jobs finish with the JAX
    service's fault-free tokens; the in-flight ones end done or error,
    never silent."""
    eng = gen_wrapper.engine
    calls = []
    reset = eng.reset

    def traced_reset():
        calls.append(("reset", threading.current_thread().name))
        reset()
    eng.reset = traced_reset
    svc = BatchedService(gen_wrapper, batch_window_s=0.0,
                         faults={"script": [{"tick": 2, "site": "kill"}]},
                         max_retries=4, retry_backoff_s=0.01,
                         watchdog_interval_s=0.05)
    quarantine = svc.scheduler.quarantine_active

    def traced_quarantine(reason, **kw):
        calls.append(("quarantine", threading.current_thread().name))
        quarantine(reason, **kw)
    svc.scheduler.quarantine_active = traced_quarantine
    try:
        first = svc._thread
        active = [svc.submit_job({"text": f"a {i}", "max_new_tokens": 24})
                  for i in range(2)]
        deadline = time.monotonic() + 30
        while (svc.stats()["robustness"]["worker_restarts"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert svc.stats()["robustness"]["worker_restarts"] == 1
        inputs = [{"text": f"q {i}", "max_new_tokens": 4} for i in range(3)]
        queued = [svc.submit_job(inp) for inp in inputs]
        done_q = _wait_jobs(svc, queued)
        assert [j.state for j in done_q] == ["done"] * 3
        assert [j.result["predictions"][0]["generated_text"]
                for j in done_q] == [jax_free(i) for i in inputs]
        for j in _wait_jobs(svc, active):
            assert j.state in ("done", "error")
            if j.state == "error":
                assert j.error
        health = svc.health()
        assert health["live"] and health["ready"] and health["worker_alive"]
        assert health["worker_restarts"] == 1
        assert svc._thread is not first and not first.is_alive()
        assert "worker killed" in svc.stats()["last_worker_error"]
    finally:
        svc.close()
        del eng.reset
    worker = f"batched-{svc.model_id}"
    assert ("quarantine", worker) in calls and ("reset", worker) in calls
    assert {name for _, name in calls} == {worker}
    eng.check_pool_invariants()


def test_repeated_faults_trigger_engine_rebuild(gen_wrapper, jax_free):
    svc = BatchedService(
        gen_wrapper, batch_window_s=0.0,
        faults={"script": [{"tick": 1, "site": "chunk"},
                           {"tick": 2, "site": "chunk"},
                           {"tick": 3, "site": "chunk"}]},
        max_retries=5, retry_backoff_s=0.01, rebuild_after_faults=2)
    try:
        inp = {"text": "rebuild me", "max_new_tokens": 6}
        assert _text(svc.predict(inp)) == jax_free(inp)
        rob = svc.stats()["robustness"]
        assert rob["engine_rebuilds"] >= 1
        assert rob["engine_faults"] >= 2
        assert svc.scheduler.fault_streak < 2
        svc.engine.check_pool_invariants()
        again = {"text": "after rebuild", "max_new_tokens": 4}
        assert _text(svc.predict(again)) == jax_free(again)
    finally:
        svc.close()


def test_service_with_unarmed_faults_matches_plain(gen_wrapper, jax_free):
    inp = {"text": "identical", "max_new_tokens": 6}
    svc = BatchedService(gen_wrapper, batch_window_s=0.0,
                         faults={"chunk_rate": 0.0})
    try:
        assert svc.fault_plane is None and svc.scheduler.faults is None
        ss = svc.scheduler.stats
        assert _text(svc.predict(inp)) == jax_free(inp)
        assert svc.stats()["robustness"]["fault_injection"] is None
        assert ss.host_reads == ss.ticks
    finally:
        svc.close()


def test_stall_is_flagged_and_brownout_notes_it(gen_wrapper, jax_free):
    """A stall fault sleeps through a tick past the stall budget: the
    watchdog counts it, brownout hears it (SOFT), and the tokens are the
    fault-free ones."""
    svc = BatchedService(gen_wrapper, batch_window_s=0.0,
                         faults={"script": [{"tick": 1, "site": "stall"}],
                                 "stall_s": 1.0},
                         stall_budget_s=0.25, watchdog_interval_s=0.02,
                         brownout={"escalate_s": 0.001, "cool_s": 60.0,
                                   "window_s": 60.0})
    try:
        inp = {"text": "stall", "max_new_tokens": 6}
        assert _text(svc.predict(inp)) == jax_free(inp)
        # escalation needs the pressure seen twice, escalate_s apart
        deadline = time.monotonic() + 10
        while (svc.health()["degradation"] != "soft"
               and time.monotonic() < deadline):
            time.sleep(0.01)
        rob = svc.stats()["robustness"]
        health = svc.health()
    finally:
        svc.close()
    # the stalled tick at least (a loaded host can slow another one)
    assert rob["tick_stalls"] >= 1
    assert rob["fault_injection"]["fired"]["stall"] == 1
    assert health["degradation"] == "soft" and health["ready"]


def test_failed_recovery_holds_readiness_down(gen_wrapper):
    """A reset that raises (as a sticky device error would make it) is
    recorded and keeps ``ready`` false; a later good recovery clears
    it."""
    eng = gen_wrapper.engine

    def broken_reset():
        raise RuntimeError("device lost")
    svc = BatchedService(gen_wrapper, batch_window_s=0.0,
                         faults={"script": [{"tick": 1, "site": "kill"}]},
                         max_retries=0, watchdog_interval_s=0.02)
    try:
        eng.reset = broken_reset
        job = svc.submit_job({"text": "lost", "max_new_tokens": 8})
        (done,) = _wait_jobs(svc, [job])
        assert done.state == "error"
        health = svc.health()
        assert health["worker_alive"] and not health["ready"]
        assert svc.stats()["last_worker_error"] == \
            "respawn recovery failed: device lost"
        del eng.reset
        assert svc._reset_engine("rebuild")
        assert svc.health()["ready"]
    finally:
        svc.close()
        if "reset" in eng.__dict__:
            del eng.reset
    eng.check_pool_invariants()
