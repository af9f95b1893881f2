"""The hybrid (RecurrentGemma) and SSM (RWKV-6) families through the JAX
package and through the port on the same (bridged) weights, on the CPU:
reduced ``recurrentgemma-9b``, reduced ``rwkv6-7b``, and a small hybrid
with the full ``("rec", "rec", "attn")`` pattern and a recurrent tail
(``num_layers=4``, applied by ``dataclasses.replace`` on both sides; the
reduced config has neither the full pattern nor a tail).

Both sides keep f32 parameters and a bf16 attention cache. Tolerances and
their reasons:
- forward / prefill logits and the f32 state leaves: atol 1e-4 rtol
  1e-4 — f32 on both sides, summed in another order (the port's CPU scans
  are sequential, the JAX package's associative or chunked);
- the bf16 attention-cache leaves: atol 2e-2 rtol 2e-2 — one bf16 ulp;
- decode logits: atol 2e-3 rtol 2e-3 — the bf16 ring cache, as for the
  dense family (tests/test_torch_model.py).
Greedy tokens must be identical: engine, scheduler, ``BatchedService``
and HTTP, including prompts whose decode wraps the hybrid's ring (its
reduced local window is 128; ``max_seq`` is 256).
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
import jax.numpy as jnp  # noqa: E402

import repro.core.assets as jassets  # noqa: E402
from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import reduce_for_smoke  # noqa: E402
from repro.core import MAXServer as JaxServer  # noqa: E402
from repro.core.registry import ModelRegistry as JaxRegistry  # noqa: E402
from repro.core.service import BatchedService as JaxBatchedService  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serving import GenerationEngine as JaxEngine  # noqa: E402
from repro.training.checkpoint import save_checkpoint  # noqa: E402
import repro_torch.core.assets as tassets  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.core.api import MAXServer  # noqa: E402
from repro_torch.core.registry import ModelRegistry  # noqa: E402
from repro_torch.core.service import BatchedService  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import check_like, to_torch_params  # noqa: E402
from repro_torch.models.transformer import CACHE_BATCH_AXIS  # noqa: E402
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine  # noqa: E402

PREFILL_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 256
TAIL = dict(block_pattern=("rec", "rec", "attn"), num_layers=4)
CASES = {"hybrid": ("recurrentgemma-9b", {}),
         "ssm": ("rwkv6-7b", {}),
         "hybrid-tail": ("recurrentgemma-9b", TAIL)}


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return [256] + [int(t) for t in rng.integers(1, 255, size=n - 1)]


# 100 tokens pad to a 128 bucket: decode past 128 wraps the hybrid's ring
PROMPTS = [_prompt(6, 1), _prompt(17, 2), _prompt(100, 3), _prompt(2, 4)]


@pytest.fixture(scope="module", params=sorted(CASES))
def bridged(request):
    name, extra = CASES[request.param]
    cfg = dataclasses.replace(reduce_for_smoke(CONFIGS[name]), **extra)
    tcfg = dataclasses.replace(t_reduce(get_config(name)), **extra)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    jm = jax_build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tm = build_model(tcfg)
    return (request.param, jm, jparams, np_params, tm,
            to_torch_params(np_params, device="cpu"))


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(1, 500, size=(B, S)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_params_cross_over_nested_and_from_a_checkpoint(bridged, tmp_path):
    """The nested blocks/l{i}/tail (hybrid) or layers/tm|cm (ssm) trees
    convert from a pytree and from a checkpoint's flat keys alike, and
    have exactly the port's own init layout."""
    case, _, _, np_params, tm, tparams = bridged
    save_checkpoint(str(tmp_path / "ck.npz"), np_params)
    flat = dict(np.load(tmp_path / "ck.npz"))
    key = "layers/tm/w_r" if case == "ssm" else "blocks/l0/rec/w_in_rnn"
    assert key in flat and ("tail/rec/lam" in flat) == (case == "hybrid-tail")
    from_flat = to_torch_params(flat, device="cpu")
    check_like(tparams, tm.init(None, "meta"))
    check_like(from_flat, tm.init(None, "meta"))

    def walk(a, b):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    walk(tparams, from_flat)


def test_forward_and_prefill_cache_match(bridged):
    _, jm, jparams, _, tm, tparams = bridged
    toks = _tokens(2, 40)
    jlogits, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    tlogits = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlogits, jlogits, PREFILL_TOL)
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                              MAX_SEQ)
    tlog, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                              cache_len=MAX_SEQ)
    _close(tlog, jlog, PREFILL_TOL)
    assert set(tcache) == set(jcache)
    for name, leaf in jcache.items():
        assert tuple(tcache[name].shape) == tuple(leaf.shape), name
        assert CACHE_BATCH_AXIS[name] < leaf.ndim
        tol = BF16_TOL if tcache[name].dtype == torch.bfloat16 \
            else PREFILL_TOL
        _close(tcache[name], leaf, tol)


def test_decode_steps_match_through_a_ring_wrap(bridged):
    """A 120-token prefill then 16 greedy decode steps (the hybrid's
    128-entry ring wraps at step 8): logits at every step and tokens."""
    _, jm, jparams, _, tm, tparams = bridged
    cfg = jm.cfg
    toks = _tokens(2, 120, seed=3)
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                              MAX_SEQ)
    jdecode = jax.jit(jm.decode_step)
    tlog, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                              cache_len=MAX_SEQ)
    tok = np.argmax(np.asarray(jlog)[:, :cfg.vocab_size], -1).astype(np.int32)
    for _ in range(16):
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(tlog, jlog, DECODE_TOL)
        nxt = np.argmax(np.asarray(jlog)[:, :cfg.vocab_size], -1)
        assert (torch.argmax(tlog[:, :cfg.vocab_size], -1).numpy()
                == nxt).all()
        tok = nxt.astype(np.int32)
    for name, leaf in jcache.items():
        tol = BF16_TOL if tcache[name].dtype == torch.bfloat16 \
            else DECODE_TOL
        _close(tcache[name], leaf, tol)


def _engines(bridged, **kw):
    _, jm, jparams, _, tm, tparams = bridged
    return (JaxEngine(jm, jparams, max_batch=4, max_seq=MAX_SEQ, **kw),
            GenerationEngine(tm, tparams, max_batch=4, max_seq=MAX_SEQ,
                             device="cpu", **kw))


def test_engine_generate_and_kv_stats_match(bridged):
    """Left-padded ring prompts (pads count as context and run through the
    recurrences), decode wrapping the ring; kv accounting equal, and 0
    bytes per token for the SSM's state."""
    case = bridged[0]
    je, te = _engines(bridged)
    assert te._ring and je._ring
    want = je.generate(PROMPTS, max_new_tokens=40)
    got = te.generate(PROMPTS, max_new_tokens=40)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finished for r in got] == [r.finished for r in want]
    for slot, p in enumerate(PROMPTS[:3]):
        je.insert_request(p, slot)
        te.insert_request(p, slot)
    assert te.kv_stats() == je.kv_stats()
    assert (te.kv_stats()["kv_bytes_per_token"] == 0) == (case == "ssm")
    assert te.max_prompt_len() == je.max_prompt_len() == 128


def test_insert_writes_only_its_slot_of_every_leaf(bridged):
    """Slot insertion by each leaf's named batch axis: a stack dimension
    of 1 (the reduced hybrid has one pattern block with one recurrent
    layer) is never taken for it."""
    _, te = _engines(bridged)
    before = {k: v.clone() for k, v in te._cache.items()}
    te.insert_request(PROMPTS[1], 2)
    for name, leaf in te._cache.items():
        ax = CACHE_BATCH_AXIS[name]
        assert leaf.shape[ax] == 4, name
        for s in range(4):
            same = torch.equal(leaf.select(ax, s), before[name].select(ax, s))
            assert same == (s != 2), (name, s)


def test_scheduler_greedy_matches_jax_scheduler(bridged):
    """More requests than slots, staggered budgets, a ring-wrapping
    request and one that hits max_seq: outputs and error codes equal."""
    je, te = _engines(bridged, decode_chunk=8)
    js, ts = JaxScheduler(je), ContinuousBatchingScheduler(te)
    budgets = [5, 9, 300, 30, 7, 2]     # the 128-token bucket hits max_seq
    prompts = PROMPTS + [_prompt(33, 5), _prompt(9, 6)]
    jr = [js.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    tr = [ts.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    js.run()
    stats = ts.run()
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.error_code for r in tr] == [r.error_code for r in jr]
    assert tr[2].error_code == "MAX_SEQ_EXCEEDED"
    assert stats.completed == len(prompts)
    assert stats.max_occupancy == 4 and stats.mean_batch_size > 1


def test_paged_knobs_on_a_ring_family_fall_back_like_jax(bridged):
    _, jm, _, _, tm, _ = bridged
    je, te = _engines(bridged, paged=True, prefix_cache=True)
    assert not te.paged and te.prefix_cache is None
    assert (te.paged, te.page_size, te.kv_pool_blocks) == \
        (je.paged, je.page_size, je.kv_pool_blocks)
    assert te.kv_stats() == je.kv_stats()
    with pytest.raises(ValueError, match="linear attention cache"):
        tm.init_cache(1, 32, device="cpu", paged=(4, 16))


# ---------------------------------------------------------------------------
# BatchedService and the HTTP front
# ---------------------------------------------------------------------------

def _asset_pair(case):
    """JAX and port assets of the case's config as it stands (built with
    smoke=False: the config is already reduced), the port's holding the
    JAX asset's seed-0 weights."""
    name, extra = CASES[case]
    cfg = dataclasses.replace(reduce_for_smoke(CONFIGS[name]), **extra,
                              name=f"{case}-smoke")
    tcfg = dataclasses.replace(t_reduce(get_config(name)), **extra,
                               name=f"{case}-smoke")
    params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(0)))
    ja = jassets._make_asset(cfg)
    ta = tassets._make_asset(tcfg)
    ja = dataclasses.replace(ja, builder=lambda a, **kw: jassets.
                             TextGenerationWrapper(a, **{**kw,
                                                         "smoke": False}))
    ta = dataclasses.replace(ta, builder=lambda a, **kw: tassets.
                             TextGenerationWrapper(a, **{**kw,
                                                         "smoke": False,
                                                         "params": params}))
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


INPUTS = [{"text": "hello", "max_new_tokens": 12},
          {"text": "the quick brown fox " * 5, "max_new_tokens": 30},
          {"text": "x", "max_new_tokens": 5},
          {"text": "model asset exchange", "max_new_tokens": 9},
          {"text": "a fifth request waits for a slot", "max_new_tokens": 7}]


def test_batched_service_matches_jax_batched_service():
    """The tailed hybrid behind both BatchedServices: the ~100-token
    request decodes past the 128-entry ring."""
    ja, ta = _asset_pair("hybrid-tail")
    kw = dict(max_seq=MAX_SEQ, max_batch=4)
    jsvc = JaxBatchedService(ja.build(**kw), batch_window_s=0.05)
    tsvc = BatchedService(ta.build(device="cpu", **kw), batch_window_s=0.05)
    try:
        want = _concurrent(jsvc.predict, INPUTS)
        got = _concurrent(tsvc.predict, INPUTS)
        stats = tsvc.stats()
    finally:
        jsvc.close()
        tsvc.close()
    assert all(e["status"] == "ok" for e in want + got), (want, got)
    assert [e["predictions"] for e in got] == [e["predictions"] for e in want]
    assert stats["completed"] == len(INPUTS) and stats["max_batch_seen"] >= 2


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


def test_http_servers_give_the_same_predictions_and_knob_answers():
    """Both MAXServers serve the three configs: the same v2 deploy
    answers for the paged / prefix knobs (ring families keep their
    layout), the same concurrent v2 and v1 predictions, the same KV
    accounting in stats."""
    jreg, treg = JaxRegistry(), ModelRegistry()
    for case in sorted(CASES):
        ja, ta = _asset_pair(case)
        jreg.register(ja)
        treg.register(ta)
    build_kw = {"max_seq": MAX_SEQ, "max_batch": 4}
    with JaxServer(registry=jreg, build_kw=build_kw,
                   service_kw={"batch_window_s": 0.1}) as js, \
            MAXServer(registry=treg, build_kw={**build_kw, "device": "cpu"},
                      service_kw={"batch_window_s": 0.1}) as ts:
        for case in sorted(CASES):
            model = f"{case}-smoke"
            for body in ({"paged": True, "page_size": 16},
                         {"paged": True, "prefix_cache": True}):
                (jc, jb), (tc, tb) = (_req(s.url, "POST",
                                           f"/v2/model/{model}/deploy", body)
                                      for s in (js, ts))
                assert tc == jc == 200, (jb, tb)
                assert tb == jb
                assert tb["kv_cache"]["paged"] is False
            preds = {}
            for s in (js, ts):
                v2 = _concurrent(lambda inp: _req(
                    s.url, "POST", f"/v2/model/{model}/predict",
                    {"input": inp}), INPUTS)
                v1 = _req(s.url, "POST", f"/model/{model}/predict",
                          {"input": "hi there"})
                assert all(c == 200 for c, _ in v2 + [v1]), v2
                preds[s] = ([b["predictions"] for _, b in v2],
                            v1[1]["predictions"])
            assert preds[ts] == preds[js]
            (_, jst), (_, tst) = (_req(s.url, "GET",
                                       f"/v2/model/{model}/stats")
                                  for s in (js, ts))
            for key in ("kv_cache", "completed", "emitted_tokens",
                        "cache_overflows", "engine_max_batch"):
                assert tst["service"][key] == jst["service"][key], key
            assert (tst["service"]["kv_cache"]["kv_bytes_per_token"]
                    == 0) == (case == "ssm")
