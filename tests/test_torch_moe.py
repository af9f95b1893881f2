"""The MoE family through the JAX package and through the port, on the
CPU: the grouped matmul's plain version (what the CUDA kernel is held to
on the card), the MoE layer, and reduced ``qwen3-moe-235b-a22b`` (qk-norm)
and ``phi3.5-moe-42b-a6.6b`` on the same (bridged) weights.

Inputs come from numpy seeds; weights from the JAX package's ``init``.
Tolerances and their reasons:
- ``gmm``: tests/test_kernels.py's f32 atol 2e-5 / rtol 2e-4 (one product
  per expert, summed in another order) and bf16 2e-2;
- ``moe_apply`` outputs at the same f32 tolerance, its aux losses at rtol
  1e-5, and the dispatched ``[E, C, d]`` rows EXACTLY equal (a scatter of
  the same rows: equal rows mean equal slots), at a capacity factor that
  drops assignments and at one that drops none;
- model logits and f32 leaves atol 1e-4 rtol 1e-4, the bf16 cache 2e-2,
  decode logits 2e-3 (tests/test_torch_model.py's PREFILL_TOL and
  DECODE_TOL, for the same reasons), greedy tokens identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import reduce_for_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.gmm import gmm as pallas_gmm  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.training.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gmm import gmm, gmm_plain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import check_like, to_torch_params  # noqa: E402

GMM_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
PREFILL_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
NAMES = ["qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b"]


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.fixture
def interpret_backend():
    """The JAX ops dispatch in interpret mode, restored even on failure."""
    jops.set_backend("interpret")
    try:
        yield
    finally:
        jops.set_backend("ref")


# ---------------------------------------------------------------------------
# gmm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", [
    (4, 128, 256, 512),
    (8, 256, 128, 128),
    (2, 384, 512, 256),
])
def test_gmm_plain_matches_pallas_interpret(E, C, d, f, dtype):
    jdt = getattr(jnp, dtype)
    x = np.asarray(jnp.asarray(_arr((E, C, d), 1), jdt).astype(jnp.float32))
    w = np.asarray(jnp.asarray(_arr((E, d, f), 2), jdt).astype(jnp.float32))
    want = pallas_gmm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                      interpret=True)
    tdt = getattr(torch, dtype)
    got = gmm_plain(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (E, C, f)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **GMM_TOL[dtype])


def test_ops_gmm_ragged_matches_jax_ops(interpret_backend):
    """A shape the Pallas wrapper zero-pads (C 60 -> 128, d 100 -> 256,
    f 300 -> 384); the port passes it as it is."""
    x, w = _arr((3, 60, 100), 1), _arr((3, 100, 300), 2)
    want = jops.gmm(jnp.asarray(x), jnp.asarray(w))
    n0, at0 = gmm.launches, dict(gmm.launches_at)
    got = ops.gmm(torch.from_numpy(x), torch.from_numpy(w))
    assert gmm.launches == n0          # the plain version: no launch
    assert dict(gmm.launches_at) == at0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **GMM_TOL["float32"])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.gmm_ref(jnp.asarray(x), jnp.asarray(w))),
        **GMM_TOL["float32"])


def test_gmm_wrapper_refuses_mixed_devices():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        gmm(x, torch.zeros(2, 16, 4, device="meta"))


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _capture(monkeypatch, module, fn):
    """Wrap ``module.gmm``: record each call's first argument (the
    dispatched rows, or the gated hidden), then run ``fn``."""
    seen = []

    def rec(x, w, *a, **kw):
        seen.append(np.asarray(x, np.float32) if not torch.is_tensor(x)
                    else x.detach().float().numpy())
        return fn(x, w, *a, **kw)
    monkeypatch.setattr(module, "gmm", rec)
    return seen


def _dropped(frac, T, C):
    """Assignments past their expert's capacity, from the per-expert
    fraction of tokens (``MoEAux.expert_fraction``)."""
    counts = np.rint(np.asarray(frac, np.float64) * T).astype(int)
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("factor", [0.5, 8.0], ids=["drops", "dropless"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_matches_jax(name, factor, monkeypatch, interpret_backend):
    cfg = reduce_for_smoke(CONFIGS[name])
    tcfg = t_reduce(get_config(name))
    jp = jmoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = to_torch_params(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    x = _arr((2, 32, cfg.d_model), 3)
    T, C = 64, jmoe.capacity(64, cfg.num_experts, cfg.num_experts_per_tok,
                             factor)
    assert C == tmoe.capacity(64, cfg.num_experts, cfg.num_experts_per_tok,
                              factor)
    jseen = _capture(monkeypatch, jops, jops.gmm)
    tseen = _capture(monkeypatch, ops, ops.gmm)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg,
                              capacity_factor=factor)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                              capacity_factor=factor)
    assert len(jseen) == len(tseen) == 3          # gate, up, down
    assert jseen[0].shape == (cfg.num_experts, C, cfg.d_model)
    np.testing.assert_array_equal(tseen[0], jseen[0])      # the slots
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                               **GMM_TOL["float32"])
    for got, want in zip(taux, jaux):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5)
    drops = _dropped(taux.expert_fraction, T, C)
    assert (drops > 0) == (factor < 1), drops
    assert drops == _dropped(jaux.expert_fraction, T, C)


def test_capacity_formula_matches_jax():
    for T in (1, 4, 8, 16, 64, 100, 1501, 2048):
        for E, K in ((4, 2), (16, 2), (128, 8)):
            for factor in (0.5, 1.0, 1.25, 8.0):
                assert tmoe.capacity(T, E, K, factor) == \
                    jmoe.capacity(T, E, K, factor)
    assert tmoe.capacity(2048, 16, 2, 1.25) == 320     # Phi-3.5-MoE prefill
    assert tmoe.capacity(4, 16, 2, 1.25) == 8          # its decode step


@pytest.mark.parametrize("E,K,C", [(4, 2, 8), (16, 2, 24)])
def test_padded_tokens_never_take_a_real_tokens_slot(E, K, C):
    """Slots are assigned in token-major, k-minor order, so tokens
    appended after the real ones (the right-padding of a prompt's bucket)
    leave every real assignment's slot as it was; the pads, all one token
    and so all routed alike, overflow to the sink."""
    rng = np.random.default_rng(5)
    R, P = 37, 40
    real = np.stack([rng.permutation(E)[:K] for _ in range(R)])
    pads = np.tile(real[-1], (P, 1))
    alone = tmoe.dispatch_slots(torch.from_numpy(real), E, C)
    padded = tmoe.dispatch_slots(
        torch.from_numpy(np.concatenate([real, pads])), E, C)
    torch.testing.assert_close(padded[:R * K], alone, rtol=0, atol=0)
    assert (padded[R * K:] == E * C).any()       # the pads overflowed
    live = padded[padded < E * C]
    assert len(torch.unique(live)) == len(live)  # non-sink slots unique


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=NAMES)
def bridged(request):
    name = request.param
    cfg = reduce_for_smoke(CONFIGS[name])
    tcfg = t_reduce(get_config(name))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    jm = jax_build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tm = build_model(tcfg)
    return (jm, jparams, np_params, tm,
            to_torch_params(np_params, device="cpu"))


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(1, 500, size=(B, S)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_params_cross_over_nested_and_from_a_checkpoint(bridged, tmp_path):
    _, _, np_params, tm, tparams = bridged
    save_checkpoint(str(tmp_path / "ck.npz"), np_params)
    flat = dict(np.load(tmp_path / "ck.npz"))
    for leaf in ("w_router", "w_gate", "w_up", "w_down"):
        assert f"layers/moe/{leaf}" in flat
    from_flat = to_torch_params(flat, device="cpu")
    like = tm.init(None, "meta")
    check_like(tparams, like)
    check_like(from_flat, like)
    assert tparams["layers"]["moe"]["w_router"].dtype == torch.float32

    def walk(a, b):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    walk(tparams, from_flat)
    bad = dict(flat)
    bad["layers/moe/w_gate"] = bad["layers/moe/w_gate"][:, :1]
    with pytest.raises(ValueError, match="w_gate"):
        check_like(to_torch_params(bad, device="cpu"), like)


def test_forward_and_loss_with_aux_match(bridged):
    jm, jparams, _, tm, tparams = bridged
    toks, targets = _tokens(2, 40), _tokens(2, 40, seed=1)
    jlogits, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    tlogits = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlogits, jlogits, PREFILL_TOL)
    jl, jmet = jm.loss(jparams, {"tokens": jnp.asarray(toks),
                                 "targets": jnp.asarray(targets)})
    tl, tmet = tm.loss(tparams, {"tokens": torch.from_numpy(toks),
                                 "targets": torch.from_numpy(targets)})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for key in ("ce", "moe_lb", "moe_z"):
        np.testing.assert_allclose(tmet[key].item(), float(jmet[key]),
                                   rtol=1e-5)


def test_prefill_cache_and_linear_decode_match(bridged):
    """A right-padded prefill (prompt lengths 40 and 23 in a 40-token
    batch) then 12 greedy decode steps with a slot that pauses: logits,
    cache leaves and tokens at every step."""
    jm, jparams, _, tm, tparams = bridged
    cfg, max_seq = jm.cfg, 64
    toks = _tokens(2, 40, seed=2)
    lengths = np.asarray([40, 23], np.int32)
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                        "prompt_lengths": jnp.asarray(
                                            lengths)}, max_seq)
    tlog, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                        "prompt_lengths": torch.from_numpy(
                                            lengths)}, cache_len=max_seq)
    _close(tlog, jlog, PREFILL_TOL)
    assert set(tcache) == set(jcache) == {"lengths", "k", "v"}
    for name, leaf in jcache.items():
        assert tuple(tcache[name].shape) == tuple(leaf.shape), name
        _close(tcache[name], leaf, BF16_TOL if name != "lengths"
               else dict(atol=0, rtol=0))
    jdecode = jax.jit(jm.decode_step)
    tok = np.argmax(np.asarray(jlog)[:, :cfg.vocab_size], -1).astype(np.int32)
    for step in range(12):
        active = np.array([True, step % 3 != 2])
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                               jnp.asarray(active))
        tlog, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                      active=torch.from_numpy(active))
        _close(tlog, jlog, DECODE_TOL)
        nxt = np.argmax(np.asarray(jlog)[:, :cfg.vocab_size], -1)
        assert (torch.argmax(tlog[:, :cfg.vocab_size], -1).numpy()
                == nxt).all()
        tok = nxt.astype(np.int32)
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))
    _close(tcache["k"], jcache["k"], BF16_TOL)


def test_paged_decode_matches(bridged):
    """Decode steps on a paged cache (shuffled pages, a masked slot):
    logits within DECODE_TOL and the written bf16 pages within one bf16
    ulp (the f32 projections are summed in another order, so a K value
    next to a bf16 rounding boundary can round one ulp apart)."""
    jm, jparams, _, tm, tparams = bridged
    rng = np.random.default_rng(4)
    N, S, P = 10, 32, 8
    jc = jm.init_cache(3, S, paged=(N, P))
    tc = tm.init_cache(3, S, device="cpu", paged=(N, P))
    table = np.full((3, S // P), N, np.int32)
    pages = list(rng.permutation(N))
    for b, n in enumerate((9, 17, 3)):
        for i in range(-(-n // P)):
            table[b, i] = pages.pop()
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
        _close(tl, jl, DECODE_TOL)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    _close(tc["k_pool"][:, :N], jc["k_pool"], BF16_TOL)
