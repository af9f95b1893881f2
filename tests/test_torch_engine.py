"""The port's GenerationEngine / ContinuousBatchingScheduler vs the JAX
package's, on the CPU, with reduced qwen3-4b on bridged weights, for a
linear cache (max_seq 32) and a ring cache (max_seq 128).

Greedy tokens must be identical. Sampled tokens are compared within the
port only (fused chunk vs single steps on one ``torch.Generator`` seed):
the JAX package draws from ``jax.random``.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import to_torch_params  # noqa: E402
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine  # noqa: E402

PROMPTS = [[256, 72, 101, 108, 108, 111], [256, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                            10, 11, 12, 13, 14, 15, 16, 17],
           [256, 9], [256, 50, 60, 70, 80]]


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"]))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = to_torch_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(t_reduce(get_config("qwen3-4b"))), tparams


def _engines(models, max_seq, **kw):
    jm, jparams, tm, tparams = models
    return (JaxEngine(jm, jparams, max_batch=4, max_seq=max_seq, **kw),
            GenerationEngine(tm, tparams, max_batch=4, max_seq=max_seq,
                             device="cpu", **kw))


@pytest.mark.parametrize("max_seq", [32, 128], ids=["linear", "ring"])
def test_generate_matches_jax_engine(models, max_seq):
    je, te = _engines(models, max_seq)
    assert te._ring == je._ring == (max_seq > 64)
    want = je.generate(PROMPTS, max_new_tokens=12)
    got = te.generate(PROMPTS, max_new_tokens=12)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finished for r in got] == [r.finished for r in want]


@pytest.mark.parametrize("max_seq,decode_chunk", [(32, 8), (128, 4)],
                         ids=["linear", "ring"])
def test_scheduler_greedy_matches_jax_scheduler(models, max_seq,
                                                decode_chunk):
    """Continuous batching with more requests than slots, staggered
    budgets (chunks end mid-way for some slots) and a request that hits
    max_seq: outputs and error codes equal the JAX scheduler's."""
    je, te = _engines(models, max_seq, decode_chunk=decode_chunk)
    js, ts = JaxScheduler(je), ContinuousBatchingScheduler(te)
    budgets = [5, 9, 3, 40, 7, 2]
    prompts = PROMPTS + [[256, 33], [256, 44, 45]]
    jr = [js.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    tr = [ts.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    js.run()
    stats = ts.run()
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.error_code for r in tr] == [r.error_code for r in jr]
    assert stats.completed == len(prompts)
    assert stats.emitted_tokens == sum(len(r.output) for r in tr)
    assert stats.max_occupancy == 4 and stats.mean_batch_size > 1


def _run_fused(eng, prompts, gen, temps, budgets, k):
    firsts = [int(eng.insert_request(p, i)) for i, p in enumerate(prompts)]
    toks, emitted = eng.step_chunk(gen, temps, budgets, k)
    toks, emitted = toks.numpy(), emitted.numpy()
    return firsts, [[int(t) for t in toks[b, :emitted[b].sum()]]
                    for b in range(len(prompts))]


def _run_stepwise(eng, prompts, gen, temps, budgets, K):
    """K single engine.step calls on the same generator, applying the
    chunk's termination rules on the host."""
    firsts = [int(eng.insert_request(p, i)) for i, p in enumerate(prompts)]
    last = np.zeros((eng.max_batch,), np.int32)
    last[:len(prompts)] = firsts
    left = np.asarray(budgets, np.int64).copy()
    run = [left[b] > 0 and (eng.eos_id is None or f != eng.eos_id)
           for b, f in enumerate(firsts)]
    outs = [[] for _ in prompts]
    for _ in range(K):
        nxt = eng.step(last, gen, temps)
        for b in range(len(prompts)):
            if not run[b]:
                continue
            tok = int(nxt[b])
            outs[b].append(tok)
            last[b] = tok
            left[b] -= 1
            if left[b] <= 0 or (eng.eos_id is not None and tok == eng.eos_id):
                run[b] = False
                eng.release_slot(b)
    return firsts, outs


@pytest.mark.parametrize("seed,k,t1,b1", [(0, 4, 0.0, 2), (1, 6, 0.7, 6),
                                          (2, 5, 1.3, 3), (3, 1, 0.7, 1)])
def test_fused_chunk_matches_single_steps(models, seed, k, t1, b1):
    """Greedy and sampled (mixed temperatures), with a budget stop in the
    middle of the chunk: the fused chunk emits the single-step tokens."""
    _, _, tm, tparams = models
    prompts = [[256, 1, 2, 3], [256, 9]]
    temps = np.asarray([0.0, t1, 0.0, 0.0], np.float32)
    budgets = np.asarray([k, b1, 0, 0], np.int32)

    def eng():
        return GenerationEngine(tm, tparams, max_batch=4, max_seq=32,
                                decode_chunk=k, device="cpu")
    ff, fused = _run_fused(eng(), prompts, torch.Generator().manual_seed(seed),
                           temps, budgets, k)
    sf, stepwise = _run_stepwise(eng(), prompts,
                                 torch.Generator().manual_seed(seed), temps,
                                 budgets, k)
    assert ff == sf
    assert fused == stepwise
    assert len(fused[1]) == min(k, b1)              # budget honoured


def test_fused_chunk_stops_on_eos_mid_chunk(models):
    """A mid-chunk EOS freezes the slot: the output ends WITH the EOS,
    nothing after it, and stepwise decode agrees."""
    _, _, tm, tparams = models
    K = 8
    temps = np.asarray([1.0, 0, 0, 0], np.float32)  # sampled: varied stream
    budgets = np.asarray([K, 0, 0, 0], np.int32)

    def eng(eos):
        return GenerationEngine(tm, tparams, max_batch=4, max_seq=32,
                                eos_id=eos, decode_chunk=K, device="cpu")
    firsts, stream = _run_fused(eng(None), [[256, 1, 2, 3]],
                                torch.Generator().manual_seed(3), temps,
                                budgets, K)
    eos = next(t for t in stream[0][1:-1] if t != firsts[0])
    stop = stream[0].index(eos) + 1
    assert 1 <= stop < K                            # genuinely mid-chunk
    _, out = _run_fused(eng(eos), [[256, 1, 2, 3]],
                        torch.Generator().manual_seed(3), temps, budgets, K)
    assert out[0] == stream[0][:stop] and out[0][-1] == eos
    _, step_out = _run_stepwise(eng(eos), [[256, 1, 2, 3]],
                                torch.Generator().manual_seed(3), temps,
                                budgets, K)
    assert step_out == out


def test_insert_returns_unforced_device_scalar(models):
    """Admission hands back a 0-d device tensor (the read is deferred), and
    it equals the greedy first token of generate()."""
    _, _, tm, tparams = models
    eng = GenerationEngine(tm, tparams, max_batch=2, max_seq=32, device="cpu")
    first = eng.insert_request([256, 1, 2, 3], 0)
    assert isinstance(first, torch.Tensor) and first.shape == ()
    eng.release_slot(0)
    assert int(first) == eng.generate([[256, 1, 2, 3]],
                                      max_new_tokens=1)[0].tokens[0]


def test_engine_bookkeeping_matches_jax(models):
    """Admission limits and KV accounting agree for both cache kinds."""
    for max_seq in (32, 100, 128):
        je, te = _engines(models, max_seq)
        assert te.max_prompt_len() == je.max_prompt_len()
        for n in (1, 15, 16, 17, 31, 32, 63, 64, 65, 99):
            assert te.fits_prompt(n) == je.fits_prompt(n), (max_seq, n)
        je.insert_request(PROMPTS[0], 1)
        te.insert_request(PROMPTS[0], 1)
        assert te.kv_stats() == je.kv_stats()
        assert te.capacity_left(1) == je.capacity_left(1)
        assert te.active_logical_tokens() == je.active_logical_tokens()


def test_scheduler_reads_once_per_tick_and_cancels(models):
    """Each tick moves its first tokens and chunk block to the host in one
    read; a cancelled queued request retires CANCELLED without a slot and
    a cancelled running one frees its slot for the queue."""
    _, _, tm, tparams = models
    eng = GenerationEngine(tm, tparams, max_batch=2, max_seq=32,
                           decode_chunk=4, device="cpu")
    sched = ContinuousBatchingScheduler(eng)
    reads = []
    real_read = sched._read

    def counting_read(toks, emitted):
        reads.append(sched.stats.ticks)
        return real_read(toks, emitted)
    sched._read = counting_read
    reqs = [sched.submit([256, 1 + i], max_new_tokens=12) for i in range(4)]
    assert sched.cancel(reqs[3].id)                 # still queued
    sched.tick()                                    # admits 0 and 1
    assert sched.cancel(reqs[0].id)                 # running
    stats = sched.run()
    assert reads == list(range(stats.ticks))        # exactly one per tick
    assert [r.error_code for r in reqs] == ["CANCELLED", None, None,
                                            "CANCELLED"]
    assert reqs[3].slot == -1 and 0 < len(reqs[0].output) < 12
    assert len(reqs[1].output) == len(reqs[2].output) == 12
    assert stats.cancelled == 2 and not sched.cancel(reqs[1].id)
