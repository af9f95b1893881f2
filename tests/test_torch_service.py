"""The port's BatchedService vs the JAX package's, on the CPU: concurrent
greedy predicts to reduced qwen3-4b on the same (bridged) weights give the
same predictions, and the port's decode batches are shared."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.assets import EXCHANGE as JAX_EXCHANGE  # noqa: E402
from repro.core.service import BatchedService as JaxBatchedService  # noqa: E402
from repro_torch.core.assets import EXCHANGE  # noqa: E402
from repro_torch.core.service import (  # noqa: E402
    BatchedService, make_service)

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
    wrapper = _port_wrapper(jax_wrapper)
    svc = make_service(wrapper, batch_window_s=0.0, max_queue=0)
    try:
        assert isinstance(svc, BatchedService)
        env = svc.predict({"text": "hi"})
        assert env["status"] == "error" and env["code"] == "QUEUE_FULL"
        assert svc.stats()["rejected"] == 1
    finally:
        svc.close()
    with pytest.raises(NotImplementedError):
        make_service(wrapper, "sync")
