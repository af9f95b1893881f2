"""The port's paged KV cache against the JAX package, on the CPU.

- ``paged_decode_attention_plain`` (what the CUDA kernel is held to on
  the card) against the Pallas ``paged_decode_attention`` in interpret
  mode: shuffled block tables, sentinel entries, poisoned unallocated
  pages, lengths 0, 1, P and P + 1; f32 pools at atol 2e-5 / rtol 2e-4
  (the repo's kernel tolerance), bf16 pools at 2e-2.
- ``paged_cache_write`` through sentinels and past the table: the live
  pages equal the JAX package's (which drops those writes) and only the
  trash page takes them.
- The paged decode step and engine on reduced ``qwen3-4b`` with bridged
  weights: logits within 1e-4 of the JAX step, greedy tokens identical to
  the JAX paged engine and scheduler, pool exhaustion, never-admissible
  prompts and cancellation retiring as in the JAX package, and the pool
  partition invariant after every retire.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import reduce_for_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention as pallas_paged,
)
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serving import GenerationEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain,
)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import to_torch_params  # noqa: E402
from repro_torch.serving import ContinuousBatchingScheduler, GenerationEngine  # noqa: E402

P = 8           # small page: tests straddle page boundaries cheaply
TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _table(rng, lens, N, nb):
    """Distinct shuffled pages per sequence, sentinel N past each length."""
    table = np.full((len(lens), nb), N, np.int32)
    free = list(rng.permutation(N))
    for b, ln in enumerate(lens):
        for i in range(-(-ln // P)):
            table[b, i] = free.pop()
    return table


def _pools(rng, N, KV, hd, table, lens, dtype):
    """Random pools, with every page no sequence owns and every row past
    a length poisoned."""
    kp = rng.normal(size=(N, P, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(N, P, KV, hd)).astype(np.float32)
    owned = np.zeros((N, P), bool)
    for b, ln in enumerate(lens):
        for t in range(ln):
            owned[table[b, t // P], t % P] = True
    kp[~owned] = 1e4
    vp[~owned] = -1e4
    if dtype == "bfloat16":       # the values both sides see
        kp = np.array(jnp.asarray(kp, jnp.bfloat16).astype(jnp.float32))
        vp = np.array(jnp.asarray(vp, jnp.bfloat16).astype(jnp.float32))
    return kp, vp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", [(0, 1, P, P + 1), (2 * P, 31, 3, 17)],
                         ids=["0-1-P-P+1", "ragged"])
def test_plain_matches_pallas_interpret(lens, dtype):
    rng = np.random.default_rng(0)
    B, H, KV, hd, N, nb = len(lens), 8, 2, 32, 12, 4
    table = _table(rng, lens, N, nb)
    kp, vp = _pools(rng, N, KV, hd, table, lens, dtype)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = pallas_paged(jnp.asarray(q), jnp.asarray(kp, jdt),
                        jnp.asarray(vp, jdt), jnp.asarray(table),
                        jnp.asarray(lens, jnp.int32), interpret=True)
    tdt = getattr(torch, dtype)
    got = paged_decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
        torch.tensor(lens, dtype=torch.int32))
    want = np.asarray(want, np.float32)
    # a length of 0 gives zeros (the Pallas kernel's l == 0 guard)
    for b, ln in enumerate(lens):
        if ln == 0:
            assert not want[b].any() and not got[b].any()
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    assert np.isfinite(got.numpy()).all()


def test_plain_matches_gather_oracle_and_wrapper_takes_it_on_cpu():
    """The plain version equals ``kernels/ref.py``'s gather oracle, and
    the wrapper (and ``ops``) take it for CPU tensors without counting a
    launch."""
    rng = np.random.default_rng(1)
    lens = (5, 16, 9)
    B, H, KV, hd, N, nb = 3, 4, 1, 64, 9, 3
    table = _table(rng, lens, N, nb)
    kp, vp = _pools(rng, N, KV, hd, table, lens, "float32")
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    want = jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens, jnp.int32))
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.tensor(lens, dtype=torch.int32))
    n0 = paged_decode_attention.launches
    for fn in (paged_decode_attention_plain, paged_decode_attention,
               ops.paged_decode_attention):
        np.testing.assert_allclose(fn(*args).numpy(), np.asarray(want),
                                   **TOL["float32"])
    assert paged_decode_attention.launches == n0


def test_wrapper_refuses_mixed_devices():
    q = torch.zeros(1, 2, 64)
    pool = torch.zeros(2, P, 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_decode_attention(q, pool, pool,
                               torch.zeros(1, 1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))


def test_paged_cache_write_drops_sentinel_and_past_table_writes():
    """Slot 0 writes into its page, slot 1 through a sentinel entry, slot
    2 past its table (length == nb * P), slot 3 at a page boundary into a
    fresh page. The live pages equal the JAX package's; the sentinel and
    past-the-table writes land only in the trash page."""
    rng = np.random.default_rng(2)
    N, KV, hd, nb = 6, 2, 16, 2
    pool = rng.normal(size=(N, P, KV, hd)).astype(np.float32)
    table = np.array([[4, N], [1, N], [2, 5], [3, 0]], np.int32)
    lengths = np.array([3, P, nb * P, P], np.int32)
    kn = rng.normal(size=(4, KV, hd)).astype(np.float32)
    vn = rng.normal(size=(4, KV, hd)).astype(np.float32)
    jk, jv = jattn.paged_cache_write(
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(table), jnp.asarray(lengths))
    trash = np.full((1, P, KV, hd), 7.0, np.float32)
    tk = torch.from_numpy(np.concatenate([pool, trash]))
    tv = tk.clone()
    tattn.paged_cache_write(tk, tv, torch.from_numpy(kn),
                            torch.from_numpy(vn), torch.from_numpy(table),
                            torch.from_numpy(lengths))
    np.testing.assert_array_equal(tk[:N].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:N].numpy(), np.asarray(jv))
    # the two dropped writes went to the trash page, at their offsets
    assert np.array_equal(tk[N, 0].numpy(), kn[1]) or \
        np.array_equal(tk[N, 0].numpy(), kn[2])
    assert (tk[N, 1:].numpy() == 7.0).all()


def test_soft_capped_paged_attention_matches_jax():
    rng = np.random.default_rng(3)
    lens = (4, 13)
    B, H, KV, hd, N, nb = 2, 4, 2, 16, 6, 2
    table = _table(rng, lens, N, nb)
    kp, vp = _pools(rng, N, KV, hd, table, lens, "float32")
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    want = jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens, jnp.int32), logit_cap=5.0)
    got = tattn.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.tensor(lens, dtype=torch.int32),
        logit_cap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


# ---------------------------------------------------------------------------
# model, engine and scheduler on reduced qwen3-4b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(reduce_for_smoke(CONFIGS["qwen3-4b"]))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = to_torch_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(t_reduce(get_config("qwen3-4b"))), tparams


def _engines(models, *, max_batch=3, max_seq=64, **kw):
    jm, jparams, tm, tparams = models
    kw = dict(max_batch=max_batch, max_seq=max_seq, paged=True, page_size=P,
              **kw)
    return (JaxEngine(jm, jparams, **kw),
            GenerationEngine(tm, tparams, device="cpu", **kw))


def test_paged_init_cache_layout_and_errors(models):
    _, _, tm, _ = models
    cache = tm.init_cache(2, 32, device="cpu", paged=(5, P))
    L = tm.cfg.num_layers
    assert tuple(cache["k_pool"].shape) == (L, 6, P, tm.cfg.num_kv_heads,
                                            tm.cfg.head_dim)
    assert (cache["block_table"] == 5).all()
    assert tuple(cache["block_table"].shape) == (2, 32 // P)
    with pytest.raises(ValueError, match="divide"):
        tm.init_cache(2, 30, device="cpu", paged=(5, P))
    with pytest.raises(ValueError, match="linear attention cache"):
        tm.init_cache(2, 128, device="cpu", paged=(5, P))   # window 64


def test_paged_decode_step_matches_jax(models):
    """Two decode steps on the same paged cache (pages shuffled, one slot
    masked): logits within 1e-4 and the written pages equal."""
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(4)
    N, S = 10, 32
    jc = jm.init_cache(3, S, paged=(N, P))
    tc = tm.init_cache(3, S, device="cpu", paged=(N, P))
    table = _table(rng, (9, 17, 3), N, S // P)
    L, KV, hd = tm.cfg.num_layers, tm.cfg.num_kv_heads, tm.cfg.head_dim
    pool = rng.normal(size=(L, N, P, KV, hd)).astype(np.float32)
    pool = np.array(jnp.asarray(pool, jnp.bfloat16).astype(jnp.float32))
    lengths = np.array([8, 16, 2], np.int32)
    jc = dict(jc, k_pool=jnp.asarray(pool, jnp.bfloat16),
              v_pool=jnp.asarray(-pool, jnp.bfloat16),
              block_table=jnp.asarray(table), lengths=jnp.asarray(lengths))
    tc["k_pool"][:, :N] = torch.from_numpy(pool).to(torch.bfloat16)
    tc["v_pool"][:, :N] = torch.from_numpy(-pool).to(torch.bfloat16)
    tc["block_table"] = torch.from_numpy(table)
    tc["lengths"] = torch.from_numpy(lengths)
    active = np.array([True, True, False])
    for tok in ([5, 6, 7], [9, 10, 11]):
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                active=jnp.asarray(active))
        tl, tc = tm.decode_step(tparams, tc, torch.tensor(tok),
                                active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    np.testing.assert_array_equal(
        tc["k_pool"][:, :N].float().numpy(),
        np.asarray(jc["k_pool"].astype(jnp.float32)))


PROMPTS = [[256, 72, 101, 108, 108, 111], list(range(1, 20)), [256, 9],
           [256] + list(range(40, 56))]


def test_paged_generate_matches_jax_engine(models):
    je, te = _engines(models, max_batch=4)
    assert te.paged and te.kv_pool_blocks == je.kv_pool_blocks
    want = je.generate(PROMPTS, max_new_tokens=12)
    got = te.generate(PROMPTS, max_new_tokens=12)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    te.check_pool_invariants()
    assert te.free_blocks() == te.kv_pool_blocks


def test_paged_tokens_equal_contiguous(models):
    """Paging changes memory, never tokens."""
    _, _, tm, tparams = models
    paged = GenerationEngine(tm, tparams, max_batch=4, max_seq=32,
                             paged=True, page_size=P, device="cpu")
    cont = GenerationEngine(tm, tparams, max_batch=4, max_seq=32,
                            device="cpu")
    prompts = [p[:20] for p in PROMPTS]
    assert [r.tokens for r in paged.generate(prompts, max_new_tokens=9)] \
        == [r.tokens for r in cont.generate(prompts, max_new_tokens=9)]


def _run_both(models, prompts, budgets, **kw):
    je, te = _engines(models, **kw)
    js, ts = JaxScheduler(je), ContinuousBatchingScheduler(te)
    jr = [js.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    tr = []
    for p, b in zip(prompts, budgets):
        tr.append(ts.submit(p, max_new_tokens=b))
    js.run()
    ts.run()
    return je, te, js, ts, jr, tr


def test_paged_scheduler_matches_jax_and_frees_every_page(models):
    """More requests than slots, staggered budgets and one request that
    reaches max_seq: outputs, error codes and pool stats equal the JAX
    scheduler's, and every page returns."""
    prompts = PROMPTS + [[256, 33], list(range(2, 50))]
    budgets = [5, 9, 3, 40, 7, 30]
    je, te, js, ts, jr, tr = _run_both(models, prompts, budgets)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.error_code for r in tr] == [r.error_code for r in jr]
    assert "MAX_SEQ_EXCEEDED" in [r.error_code for r in tr]
    assert te.kv_stats() == je.kv_stats()
    te.check_pool_invariants()
    assert te.free_blocks() == te.kv_pool_blocks


def test_pool_exhaustion_retires_like_jax(models):
    """A request that outgrows a 4-page pool retires KV_POOL_EXHAUSTED
    with its partial output; its co-tenant finishes; the counts match."""
    prompts = [list(range(1, 9)), list(range(1, 7))]
    je, te, js, ts, jr, tr = _run_both(models, prompts, [40, 2],
                                       kv_pool_blocks=4)
    assert [r.error_code for r in tr] == ["KV_POOL_EXHAUSTED", None]
    assert [r.output for r in tr] == [r.output for r in jr]
    assert 0 < len(tr[0].output) < 40
    assert ts.stats.pool_exhausted == js.stats.pool_exhausted == 1
    te.check_pool_invariants()
    assert te.free_blocks() == 4


def test_block_gate_serializes_and_never_admissible_retires(models):
    """A 3-page pool admits 2-page prompts one at a time, and a prompt
    needing more pages than the pool holds retires at once."""
    prompts = [list(range(1, 16))] * 3 + [list(range(1, 30))]
    je, te, js, ts, jr, tr = _run_both(models, prompts, [3, 3, 3, 2],
                                       kv_pool_blocks=3)
    assert [r.error_code for r in tr] == [None] * 3 + ["KV_POOL_EXHAUSTED"]
    assert [r.output for r in tr] == [r.output for r in jr]
    ticks = sorted(r.admitted_at_tick for r in tr[:3])
    assert ticks[0] < ticks[1] < ticks[2]
    assert tr[3].slot == -1
    te.check_pool_invariants()


def test_cancel_frees_every_page_and_invariants_hold_after_each_retire(
        models):
    _, te = _engines(models)
    sched = ContinuousBatchingScheduler(te)
    run = sched.submit(list(range(1, 12)), max_new_tokens=30)
    queued = sched.submit([1, 2], max_new_tokens=30)
    short = sched.submit([3, 4, 5], max_new_tokens=2)
    done = 0
    sched.tick()
    assert te.blocks_in_use() > 0
    assert sched.cancel(run.id) and sched.cancel(queued.id)
    while sched.has_work():
        sched.tick()
        n = sched.stats.completed + sched.stats.cancelled
        if n != done:                   # something retired this tick
            te.check_pool_invariants()
            done = n
    assert run.error_code == queued.error_code == "CANCELLED"
    assert short.error_code is None and len(short.output) == 2
    assert te.free_blocks() == te.kv_pool_blocks


def test_ring_config_keeps_linear_layout(models):
    """Paging applies to linear caches: reduced qwen3-4b at max_seq 128
    (window 64) is a ring and silently keeps the linear layout, as in the
    JAX package."""
    je, te = _engines(models, max_seq=128)
    assert not te.paged and not je.paged
    assert te.kv_stats()["paged"] is False
