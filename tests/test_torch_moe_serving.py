"""The MoE family served by the JAX package and by the port, on the CPU:
reduced ``phi3.5-moe-42b-a6.6b`` and ``qwen3-moe-235b-a22b`` on the same
(bridged) weights through the engine (contiguous, paged, and paged with
the prefix cache), the scheduler, ``BatchedService`` and the HTTP front.

Greedy tokens must be identical to the JAX package's at every layer. An
MoE forward depends on how many tokens share the call (the capacity ``C``
drops assignments past it), so a prefix-cached warm run (cached pages,
then the tail through decode steps) is held to the JAX engine's warm run
and a cold run to the JAX engine's cold run, not to each other. The
prompts include prefills that drop assignments, counted from the port's
router (``MoEAux.expert_fraction``), so the comparison covers dropping.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.assets as jassets  # noqa: E402
from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import reduce_for_smoke  # noqa: E402
from repro.core import MAXServer as JaxServer  # noqa: E402
from repro.core.registry import ModelRegistry as JaxRegistry  # noqa: E402
from repro.core.service import BatchedService as JaxBatchedService  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serving import GenerationEngine as JaxEngine  # noqa: E402
import repro_torch.core.assets as tassets  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.core.api import MAXServer  # noqa: E402
from repro_torch.core.registry import ModelRegistry  # noqa: E402
from repro_torch.core.service import BatchedService  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import to_torch_params  # noqa: E402
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine  # noqa: E402

NAMES = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"]
MAX_SEQ, P = 128, 8


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return [256] + [int(t) for t in rng.integers(1, 255, size=n - 1)]


# buckets 16, 32, 64, 128: the 70-token prompt's prefill (T = 128)
PROMPTS = [_prompt(6, 1), _prompt(29, 2), _prompt(70, 3), _prompt(2, 4)]


@pytest.fixture(scope="module", params=NAMES)
def bridged(request):
    cfg = reduce_for_smoke(CONFIGS[request.param])
    tcfg = t_reduce(get_config(request.param))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    jm = jax_build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = to_torch_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(tcfg), tparams


def _engines(bridged, **kw):
    jm, jparams, tm, tparams = bridged
    kw = dict(max_batch=4, max_seq=MAX_SEQ, **kw)
    return (JaxEngine(jm, jparams, **kw),
            GenerationEngine(tm, tparams, device="cpu", **kw))


@pytest.fixture
def drops(monkeypatch):
    """Assignments each port MoE call dropped, as (tokens in the call,
    dropped), read from the router's per-expert fractions."""
    seen = []
    apply = tmoe.moe_apply

    def rec(params, x, cfg, **kw):
        y, aux = apply(params, x, cfg, **kw)
        T = x.shape[0] * x.shape[1]
        C = tmoe.capacity(T, cfg.num_experts, cfg.num_experts_per_tok,
                          kw.get("capacity_factor")
                          or cfg.moe_capacity_factor)
        counts = torch.round(aux.expert_fraction.double() * T).long()
        seen.append((T, int((counts - C).clamp(min=0).sum())))
        return y, aux
    monkeypatch.setattr(tmoe, "moe_apply", rec)
    return seen


@pytest.mark.parametrize("layout", [{}, {"paged": True, "page_size": P}],
                         ids=["contiguous", "paged"])
def test_engine_generate_matches_jax(bridged, layout, drops):
    """Right-padded prompts of 2-70 tokens, 24 greedy tokens each: the
    same tokens and KV accounting as the JAX engine; some prefill dropped
    assignments and no decode step did."""
    je, te = _engines(bridged, **layout)
    assert not te._ring and te.paged == bool(layout)
    want = je.generate(PROMPTS, max_new_tokens=24)
    got = te.generate(PROMPTS, max_new_tokens=24)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finished for r in got] == [r.finished for r in want]
    assert te.kv_stats() == je.kv_stats()
    assert any(n > 0 for T, n in drops if T > te.max_batch), drops
    assert all(n == 0 for T, n in drops if T == te.max_batch)
    if te.paged:
        te.check_pool_invariants()


def test_prefix_cache_warm_and_cold_match_jax(bridged):
    """Run 1 cold, run 2 a warm replay, run 3 a partial hit with new
    tails, run 4 a whole-prompt hit (copy-on-write): tokens equal the
    JAX engine's run for run, and so do the prefix counters and pool
    stats."""
    je, te = _engines(bridged, paged=True, page_size=P, prefix_cache=True,
                      decode_chunk=4)
    shared = _prompt(44, 7)
    runs = [[shared + [30], shared + [40, 41]],
            [shared + [30], shared + [40, 41]],
            [shared[:20] + [50, 51, 52], shared + [60]],
            [shared[:40]]]
    for prompts in runs:
        want = [r.tokens for r in je.generate(prompts, max_new_tokens=10)]
        got = [r.tokens for r in te.generate(prompts, max_new_tokens=10)]
        assert got == want
        assert te.prefix_stats() == je.prefix_stats()
        assert te.kv_stats() == je.kv_stats()
        te.check_pool_invariants()
    assert te.prefix_cache.hit_tokens > 0 and te.prefix_cache.cow_copies


def test_scheduler_greedy_matches_jax_scheduler(bridged):
    """More requests than slots over the prefix-cached paged pool,
    staggered budgets and one that hits max_seq: outputs, error codes and
    counters equal."""
    je, te = _engines(bridged, paged=True, page_size=P, prefix_cache=True,
                      decode_chunk=8)
    js, ts = JaxScheduler(je), ContinuousBatchingScheduler(te)
    budgets = [5, 9, 200, 30, 7, 2]
    prompts = PROMPTS + [PROMPTS[2][:50] + [9, 9], _prompt(9, 6)]
    jr = [js.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    tr = [ts.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    js.run()
    stats = ts.run()
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.error_code for r in tr] == [r.error_code for r in jr]
    assert tr[2].error_code == "MAX_SEQ_EXCEEDED"
    assert stats.completed == len(prompts)
    assert stats.max_occupancy == 4 and stats.mean_batch_size > 1
    assert te.prefix_stats() == je.prefix_stats()
    te.check_pool_invariants()


# ---------------------------------------------------------------------------
# BatchedService and the HTTP front
# ---------------------------------------------------------------------------

def _asset_pair(name):
    """JAX and port assets of the reduced config (built with smoke=False:
    the config is already reduced), the port's holding the JAX asset's
    seed-0 weights."""
    cfg = dataclasses.replace(reduce_for_smoke(CONFIGS[name]),
                              name=f"{name}-smoke")
    tcfg = dataclasses.replace(t_reduce(get_config(name)),
                               name=f"{name}-smoke")
    params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(0)))
    ja = dataclasses.replace(
        jassets._make_asset(cfg), builder=lambda a, **kw: jassets.
        TextGenerationWrapper(a, **{**kw, "smoke": False}))
    ta = dataclasses.replace(
        tassets._make_asset(tcfg), builder=lambda a, **kw: tassets.
        TextGenerationWrapper(a, **{**kw, "smoke": False, "params": params}))
    return ja, ta


def _concurrent(fn, inputs):
    out = [None] * len(inputs)
    gate = threading.Barrier(len(inputs))

    def go(i):
        gate.wait(timeout=30)
        out[i] = fn(inputs[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


# no two share a page: with the prefix cache, a request admitted after
# another that shares its prefix would hit it, and a hit changes an MoE
# request's function, so concurrent tokens would depend on arrival order
INPUTS = [{"text": "hello, a request with a page or two", "max_new_tokens": 12},
          {"text": "the quick brown fox " * 3, "max_new_tokens": 30},
          {"text": "x", "max_new_tokens": 5},
          {"text": "model asset exchange", "max_new_tokens": 9},
          {"text": "a fifth request waits for a slot", "max_new_tokens": 7}]


def test_batched_service_matches_jax_batched_service():
    """Reduced Phi-3.5-MoE on the prefix-cached paged pool behind both
    BatchedServices: the same envelopes, then a warm replay of the same
    inputs equal to the JAX service's warm replay."""
    ja, ta = _asset_pair("phi3.5-moe-42b-a6.6b")
    kw = dict(max_seq=MAX_SEQ, max_batch=4, paged=True, page_size=P,
              prefix_cache=True)
    jsvc = JaxBatchedService(ja.build(**kw), batch_window_s=0.05)
    tsvc = BatchedService(ta.build(device="cpu", **kw), batch_window_s=0.05)
    try:
        for _ in range(2):                     # cold, then warm
            want = _concurrent(jsvc.predict, INPUTS)
            got = _concurrent(tsvc.predict, INPUTS)
            assert all(e["status"] == "ok" for e in want + got), (want, got)
            assert [e["predictions"] for e in got] == \
                [e["predictions"] for e in want]
        stats = tsvc.stats()
    finally:
        jsvc.close()
        tsvc.close()
    assert stats["completed"] == 2 * len(INPUTS)
    assert stats["max_batch_seen"] >= 2
    assert stats["prefix_cache"]["hit_tokens"] > 0


def _req(url, method, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url + path, data,
                                 {"Content-Type": "application/json"},
                                 method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_servers_give_the_same_predictions_and_stats():
    """Both MAXServers serve both reduced MoE configs deployed with
    ``{"paged": true, "prefix_cache": true}``: the same deploy answer, the
    same concurrent v2 predicts, a v1 predict and a warm v2 replay, and the
    same KV and prefix accounting in stats."""
    jreg, treg = JaxRegistry(), ModelRegistry()
    for name in NAMES:
        ja, ta = _asset_pair(name)
        jreg.register(ja)
        treg.register(ta)
    build_kw = {"max_seq": MAX_SEQ, "max_batch": 4}
    with JaxServer(registry=jreg, build_kw=build_kw,
                   service_kw={"batch_window_s": 0.1}) as js, \
            MAXServer(registry=treg, build_kw={**build_kw, "device": "cpu"},
                      service_kw={"batch_window_s": 0.1}) as ts:
        for name in NAMES:
            model = f"{name}-smoke"
            body = {"paged": True, "page_size": P, "prefix_cache": True}
            (jc, jb), (tc, tb) = (_req(s.url, "POST",
                                       f"/v2/model/{model}/deploy", body)
                                  for s in (js, ts))
            assert tc == jc == 200, (jb, tb)
            assert tb == jb and tb["kv_cache"]["paged"] is True
            preds = {}
            for s in (js, ts):
                v2 = _concurrent(lambda inp: _req(
                    s.url, "POST", f"/v2/model/{model}/predict",
                    {"input": inp}), INPUTS)
                v1 = _req(s.url, "POST", f"/model/{model}/predict",
                          {"input": "hi there"})
                warm = _req(s.url, "POST", f"/v2/model/{model}/predict",
                            {"input": INPUTS[1]})
                assert all(c == 200 for c, _ in v2 + [v1, warm]), v2
                preds[s] = ([b["predictions"] for _, b in v2],
                            v1[1]["predictions"], warm[1]["predictions"])
            assert preds[ts] == preds[js]
            (_, jst), (_, tst) = (_req(s.url, "GET",
                                       f"/v2/model/{model}/stats")
                                  for s in (js, ts))
            for key in ("kv_cache", "prefix_cache", "completed",
                        "emitted_tokens", "cache_overflows",
                        "engine_max_batch"):
                assert tst["service"][key] == jst["service"][key], key
            assert tst["service"]["prefix_cache"]["hit_tokens"] > 0
            ts.manager.get(model).wrapper.engine.check_pool_invariants()
