"""The port's services vs the JAX package's, on the CPU: concurrent
greedy predicts to reduced qwen3-4b on the same (bridged) weights give the
same predictions through BatchedService (decode batches shared) and
through SyncService (one generation at a time on the request thread, jobs
on a background worker), for the contiguous and the paged layout; jobs
expire after their TTL and cancel alike. Tokens are compared exactly."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.assets import EXCHANGE as JAX_EXCHANGE  # noqa: E402
from repro.core.service import BatchedService as JaxBatchedService  # noqa: E402
from repro.core.service import SyncService as JaxSyncService  # noqa: E402
from repro_torch.core.assets import EXCHANGE  # noqa: E402
from repro_torch.core.service import (  # noqa: E402
    BatchedService, ServiceOverloaded, SyncService, make_service)

TEXTS = ["hello", "the quick brown fox", "MAX", "a longer prompt to prefill",
         "x", "model asset exchange"]


def _concurrent(svc, inputs):
    out = [None] * len(inputs)
    gate = threading.Barrier(len(inputs))

    def go(i):
        gate.wait(timeout=30)
        out[i] = svc.predict(inputs[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def jax_wrapper():
    return JAX_EXCHANGE.get("qwen3-4b").build(max_seq=128, max_batch=4)


def _port_wrapper(jax_wrapper, **kw):
    params = jax.tree_util.tree_map(np.asarray, jax_wrapper.params)
    return EXCHANGE.get("qwen3-4b").build(max_seq=128, max_batch=4,
                                          device="cpu", params=params, **kw)


def test_batched_service_matches_jax_batched_service(jax_wrapper):
    inputs = [{"text": t, "max_new_tokens": 6 + i % 4}
              for i, t in enumerate(TEXTS)]
    jsvc = JaxBatchedService(jax_wrapper, batch_window_s=0.05)
    tsvc = BatchedService(_port_wrapper(jax_wrapper), batch_window_s=0.05)
    try:
        want = _concurrent(jsvc, inputs)
        got = _concurrent(tsvc, inputs)
        stats = tsvc.stats()
    finally:
        jsvc.close()
        tsvc.close()
    assert all(e["status"] == "ok" for e in want + got), (want, got)
    assert [e["predictions"] for e in got] == [e["predictions"] for e in want]
    assert stats["completed"] == len(inputs)
    assert stats["mean_batch_size"] > 1 and stats["max_batch_seen"] >= 2
    assert stats["ttft"]["count"] == len(inputs)


def test_predict_batch_and_errors(jax_wrapper):
    svc = BatchedService(_port_wrapper(jax_wrapper))
    try:
        envs = svc.predict_batch([{"text": "hi", "max_new_tokens": 3},
                                  {"no_text": 1},
                                  {"text": "ok", "max_new_tokens": 2}])
        assert [e["status"] for e in envs] == ["ok", "error", "ok"]
        assert envs[1]["code"] == "INVALID_INPUT"
        assert envs[0]["predictions"][0]["generated_tokens"] == 3
        # the wrapper truncates to the longest admissible prompt, so an
        # over-long text still runs
        env = svc.predict({"text": "y" * 500, "max_new_tokens": 2})
        assert env["status"] == "ok"
        assert env["predictions"][0]["prompt_tokens"] == \
            svc.engine.max_prompt_len()
    finally:
        svc.close()
    assert svc.predict("late")["status"] == "error"   # closed


def test_queue_bound_and_factory(jax_wrapper):
    """The per-class admission queue bounds the batched service (QUEUE_FULL
    at submit, a non-positive bound is refused as QoSConfig refuses it),
    and the factory picks each mode as the JAX one does."""
    wrapper = _port_wrapper(jax_wrapper)
    with pytest.raises(ValueError):
        make_service(wrapper, batch_window_s=0.0, max_queue=0)
    # a long window holds the first request in the queue
    svc = make_service(wrapper, batch_window_s=30.0, max_queue=1)
    try:
        assert isinstance(svc, BatchedService)
        held = svc.submit_job({"text": "hi"})
        with pytest.raises(ServiceOverloaded):
            svc.submit_job({"text": "hi"})
        env = svc.predict({"text": "hi"})
        assert env["status"] == "error" and env["code"] == "QUEUE_FULL"
        assert svc.stats()["rejected"] == 2
    finally:
        svc.close()
    assert held.state == "error"              # failed by close, not stranded
    sync = make_service(wrapper, "sync")
    assert isinstance(sync, SyncService) and sync.kind == "sync"
    sync.close()
    with pytest.raises(ValueError):
        make_service(wrapper, "wat")


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_sync_service_matches_jax_sync_and_batched(jax_wrapper, paged):
    """SyncService greedy tokens equal the JAX SyncService's on the same
    weights and the port's own batched service's."""
    kw = {"paged": True, "page_size": 16} if paged else {}
    inputs = [{"text": t, "max_new_tokens": 5 + i % 3}
              for i, t in enumerate(TEXTS[:4])]
    jsync = JaxSyncService(JAX_EXCHANGE.get("qwen3-4b").build(
        max_seq=128, max_batch=4, **kw))
    tsync = SyncService(_port_wrapper(jax_wrapper, **kw))
    batched = BatchedService(_port_wrapper(jax_wrapper, **kw))
    try:
        want = [jsync.predict(i) for i in inputs]
        got = _concurrent(tsync, inputs)      # serialized on its engine
        ref = batched.predict_batch(inputs)
    finally:
        batched.close()
        tsync.close()
        jsync.close()
    assert all(e["status"] == "ok" for e in want + got + ref)

    def toks(envs):
        return [(e["predictions"][0]["generated_text"],
                 e["predictions"][0]["generated_tokens"]) for e in envs]
    assert toks(got) == toks(want) == toks(ref)
    assert all("ttft_ms" in e["predictions"][0] for e in got)
    st = tsync.stats()
    assert st["kind"] == "sync" and st["ttft"]["count"] == len(inputs)
    assert st["qos"]["queued"] == 0


def _wait_state(job, states=("done", "error", "cancelled"), timeout_s=60):
    deadline = time.monotonic() + timeout_s
    while job.state not in states and time.monotonic() < deadline:
        time.sleep(0.01)
    return job.state


def test_sync_jobs_run_in_background_and_expire(jax_wrapper):
    svc = SyncService(_port_wrapper(jax_wrapper), job_ttl_s=2.0)
    jsvc = JaxSyncService(jax_wrapper)
    try:
        inp = {"text": "a job", "max_new_tokens": 4}
        job = svc.submit_job(inp)
        assert _wait_state(job) == "done"
        assert svc.get_job(job.id) is job           # alive inside the TTL
        jjob = jsvc.submit_job(inp)
        assert _wait_state(jjob) == "done"
        strip = [{k: v for k, v in p.items() if k != "ttft_ms"}
                 for p in job.result["predictions"]]
        assert strip == [{k: v for k, v in p.items() if k != "ttft_ms"}
                         for p in jjob.result["predictions"]]
        events = list(job.stream.subscribe(0, timeout_s=1))
        assert [(e.event, e.seq) for e in events] == [("token", 0),
                                                      ("done", 1)]
        assert events[1].data["usage"]["completion_tokens"] == 4
        time.sleep(2.1)
        with pytest.raises(KeyError):
            svc.get_job(job.id)                     # expired
        assert svc.stats()["jobs"] == 0
        with pytest.raises(KeyError):
            svc.get_trace("nope")
    finally:
        svc.close()
        jsvc.close()


def test_sync_cancel_and_close_never_strand_jobs(jax_wrapper):
    """A cancel that answered True ends 'cancelled' even when it races the
    worker; close fails what is still queued."""
    svc = SyncService(_port_wrapper(jax_wrapper))
    try:
        jobs = [svc.submit_job({"text": f"job {i}", "max_new_tokens": 8})
                for i in range(4)]
        answers = [svc.cancel_job(j.id) for j in jobs[1:]]
        for job, cancelled in zip(jobs[1:], answers):
            state = _wait_state(job)
            assert state == ("cancelled" if cancelled else "done"), state
        assert _wait_state(jobs[0]) == "done"
        assert svc.cancel_job(jobs[0].id) is False
        assert svc.delete_job(jobs[0].id) is True
        assert svc.delete_job(jobs[0].id) is False
        last = svc.submit_job({"text": "late", "max_new_tokens": 30})
    finally:
        svc.close()
    assert _wait_state(last, timeout_s=10) in ("done", "error")
