"""The port's prefix cache against the JAX package, on the CPU.

- ``PrefixCache``: chained page keys byte-identical to the JAX package's
  for the same tokens, and the same match / register / LRU behaviour.
- The prefix-cached paged engine on reduced ``qwen3-4b`` with bridged
  weights: a cold run, a warm replay, a partial hit and a whole-prompt hit
  (copy-on-write) give greedy tokens identical to the JAX engine's and to
  their own cold runs; the prefix counters, the pool stats and the
  admission charges equal the JAX engine's; cached page bytes never change;
  the pool partition invariant holds after every operation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import reduce_for_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serving import GenerationEngine as JaxEngine  # noqa: E402
from repro.serving import PrefixCache as JaxPrefixCache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import to_torch_params  # noqa: E402
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402

P = 8
PREFIX = list(range(1, 21))          # 20 tokens: 2 full pages + a tail
ALIGNED = PREFIX[:2 * P]             # exactly 2 pages


@pytest.mark.parametrize("page_size,n", [(8, 0), (8, 7), (8, 64), (16, 100),
                                         (16, 1024), (5, 33)])
def test_chain_keys_byte_identical_to_jax(page_size, n):
    toks = [int(t) for t in np.random.default_rng(n).integers(0, 151936, n)]
    keys = PrefixCache(page_size).chain_keys(toks)
    assert keys == JaxPrefixCache(page_size).chain_keys(toks)
    assert len(keys) == n // page_size
    assert all(isinstance(k, bytes) and len(k) == 16 for k in keys)


def test_cache_operations_match_jax():
    """The same register / match / release sequence gives the same pages,
    evictions and counters, with an LRU cap of 2."""
    caches = [PrefixCache(P, max_unreferenced=2),
              JaxPrefixCache(P, max_unreferenced=2)]
    toks = list(range(40))
    outs = []
    for pc in caches:
        keys = pc.chain_keys(toks)
        got = [pc.register(keys[0], 5), pc.register(keys[1], 9),
               pc.register(keys[0], 7), pc.register(keys[3], 2),
               pc.match(toks, peek=True), pc.match(toks[:P] + [999] + toks),
               pc.release_page(5), pc.release_page(9), pc.release_page(2),
               pc.evictable(), pc.pop_evictable(), pc.cached_pages(),
               pc.stats()]
        outs.append(got)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"]))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = to_torch_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(t_reduce(get_config("qwen3-4b"))), tparams


def _engines(models, *, max_batch=2, max_seq=64, pool=None, cap=None, K=4):
    jm, jparams, tm, tparams = models
    kw = dict(max_batch=max_batch, max_seq=max_seq, decode_chunk=K,
              paged=True, page_size=P, kv_pool_blocks=pool,
              prefix_cache=True, prefix_cache_pages=cap)
    return (JaxEngine(jm, jparams, **kw),
            GenerationEngine(tm, tparams, device="cpu", **kw))


def _cold(models, prompts, **kw):
    """Tokens of a fresh prefix-less paged engine (the cold reference)."""
    _, _, tm, tparams = models
    eng = GenerationEngine(tm, tparams, max_batch=2, max_seq=64, paged=True,
                           page_size=P, device="cpu")
    return [r.tokens for r in eng.generate(prompts, **kw)]


def _same(je, te):
    assert te.prefix_stats() == je.prefix_stats()
    assert te.kv_stats() == je.kv_stats()
    te.check_pool_invariants()


def test_cold_warm_and_partial_hits_match_jax(models):
    """Run 1 is cold, run 2 a warm replay of the same pair, run 3 a
    partial hit (the shared prefix with new tails): tokens equal the JAX
    engine's and the cold reference, counters equal the JAX engine's."""
    je, te = _engines(models)
    kw = dict(max_new_tokens=8)
    pairs = [(PREFIX + [30], PREFIX + [40, 41]),
             (PREFIX + [30], PREFIX + [40, 41]),
             (PREFIX[:12] + [50, 51, 52], PREFIX + [60])]
    hits = []
    for pair in pairs:
        want = [r.tokens for r in je.generate(list(pair), **kw)]
        got = [r.tokens for r in te.generate(list(pair), **kw)]
        assert got == want == _cold(models, list(pair), **kw)
        _same(je, te)
        hits.append(te.prefix_cache.hit_tokens)
    assert hits[0] == 2 * P      # the second prompt of the cold pair hit
    assert hits[1] > hits[0] and hits[2] > hits[1]


def test_whole_prompt_hit_copies_on_write_and_keeps_cached_bytes(models):
    """A page-aligned prompt replayed whole re-feeds its last token into
    the last shared page, which is copied first: tokens equal the cold run
    and the cached pages' bytes do not change."""
    je, te = _engines(models)
    ref = _cold(models, [ALIGNED], max_new_tokens=6)
    for run in range(3):
        assert [r.tokens for r in je.generate([ALIGNED], max_new_tokens=6)] \
            == ref
        assert [r.tokens for r in te.generate([ALIGNED], max_new_tokens=6)] \
            == ref
        _same(je, te)
        if run == 0:
            pages = te.prefix_cache.cached_pages()
            before = te._cache["k_pool"][:, pages].clone()
    assert te.prefix_cache.cow_copies == 2
    te.generate([ALIGNED + [50, 51]], max_new_tokens=6)
    assert torch.equal(te._cache["k_pool"][:, pages], before)


def test_cobatched_duplicates_share_pages(models):
    je, te = _engines(models)
    for eng in (je, te):
        for i, p in enumerate((PREFIX + [30, 31], PREFIX + [40, 41, 42])):
            eng.insert_request(p, i)
    _same(je, te)
    assert te.prefix_stats()["shared_pages"] == 2
    assert te._slot_blocks[0][:2] == te._slot_blocks[1][:2]


def test_admission_charges_match_jax(models):
    """blocks_for_prompt / can_admit charge only the pages the cache cannot
    seat, plus the copy-on-write page of a whole-prompt hit."""
    je, te = _engines(models, pool=5)
    probes = [PREFIX + [30, 31], PREFIX + [40, 41], ALIGNED, 22, 16]
    for eng in (je, te):
        eng.insert_request(PREFIX + [30, 31], 0)
    for p in probes:
        assert te.blocks_for_prompt(p) == je.blocks_for_prompt(p), p
        assert te.can_admit(p) == je.can_admit(p), p
    assert te.blocks_for_prompt(PREFIX + [40, 41]) == 1
    assert not te.can_admit(22) and te.can_admit(PREFIX + [40, 41])


def test_lru_eviction_rescues_admission(models):
    je, te = _engines(models, max_batch=1, pool=3)
    for eng in (je, te):
        eng.generate([list(range(1, 17))], max_new_tokens=4)
    assert te.free_blocks() == 1 and te.available_blocks() == 3
    for eng in (je, te):
        out = eng.generate([list(range(100, 116))], max_new_tokens=4)
    _same(je, te)
    assert te.prefix_cache.evictions == 2
    assert out[0].tokens == _cold(models, [list(range(100, 116))],
                                  max_new_tokens=4)[0]


def test_scheduler_with_prefix_cache_matches_jax(models):
    """Continuous batching over shared prefixes, a multi-turn continuation
    (hits the decoded pages the first turn registered at retire) and a
    pool that only sharing makes feasible: outputs, errors and counters
    equal the JAX scheduler's, invariants hold after every retire."""
    je, te = _engines(models, max_batch=2, pool=6)
    js, ts = JaxScheduler(je), ContinuousBatchingScheduler(te)
    prompts = [PREFIX + [30, 31], PREFIX + [40, 41], ALIGNED, [256, 7]]
    budgets = [12, 3, 5, 4]
    jr = [js.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    tr = [ts.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    js.run()
    done = 0
    while ts.has_work():
        ts.tick()
        if ts.stats.completed != done:
            te.check_pool_invariants()
            done = ts.stats.completed
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.error_code for r in tr] == [r.error_code for r in jr]
    _same(je, te)
    turn2 = prompts[0] + tr[0].output[:6]        # 28 tokens -> 3 pages
    assert len(te.prefix_cache.match(turn2, peek=True)) == 3
    j2, t2 = (js.submit(turn2, max_new_tokens=5),
              ts.submit(turn2, max_new_tokens=5))
    js.run()
    ts.run()
    assert t2.output == j2.output and t2.error_code is None
    _same(je, te)


def test_random_operations_keep_the_pool_partition_like_jax(models):
    """Seeded random admit / decode / retire / cancel sequences on both
    engines: the same greedy tokens, prefix counters and pool stats, and
    the partition invariant (free | live with exact refcounts | cached in
    the LRU) after every operation."""
    prompts = ([PREFIX + [30 + i] for i in range(3)]
               + [PREFIX[:P] + [50 + i] * 3 for i in range(2)]
               + [ALIGNED, [70 + i for i in range(5)]])
    for seed in range(3):
        ops_ = np.random.default_rng(seed).integers(0, 10, 18)
        je, te = _engines(models, max_batch=3, pool=10, cap=4)
        fed = {}
        for op in ops_:
            if op <= 4:
                free = te.free_slots()
                if not free:
                    continue
                slot, prompt = free[0], prompts[op % len(prompts)]
                try:
                    jf = int(je.insert_request(prompt, slot))
                except RuntimeError:
                    with pytest.raises(RuntimeError, match="exhausted"):
                        te.insert_request(prompt, slot)
                    assert slot in te.free_slots()
                    continue
                assert int(te.insert_request(prompt, slot)) == jf
                fed[slot] = list(prompt) + [jf]
            elif op <= 6 and fed:
                last = np.zeros((te.max_batch,), np.int32)
                for s, toks in fed.items():
                    last[s] = toks[-1]
                before = te._lengths.copy()
                jn = je.step(last, jax.random.PRNGKey(0), 0.0)
                tn = te.step(last, None, 0.0)
                np.testing.assert_array_equal(te._lengths, je._lengths)
                for s in list(fed):
                    if te._lengths[s] > before[s]:
                        assert int(tn[s]) == int(jn[s])
                        fed[s].append(int(tn[s]))
            elif fed:
                slot = sorted(fed)[0]
                toks = fed.pop(slot) if op < 9 else None
                je.release_slot(slot, tokens=toks)
                te.release_slot(slot, tokens=toks)
                if op == 9:
                    fed.pop(slot, None)
            _same(je, te)
        for slot in list(fed):
            toks = fed.pop(slot)
            je.release_slot(slot, tokens=toks)
            te.release_slot(slot, tokens=toks)
            _same(je, te)
        assert te.prefix_cache.evictable() <= 4
