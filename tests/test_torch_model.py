"""Reduced qwen3-4b through the JAX package and through the port on the
same (bridged) weights, on the CPU, for a linear cache (max_seq 32 <= the
reduced 64-token window) and a ring cache (max_seq 128).

Both sides keep f32 parameters and a bf16 cache, so rounding happens at
the same places. Tolerances and their reasons:
- prefill / forward logits: atol 1e-4 rtol 1e-4 — f32 on both sides, two
  layers of products summed in a different order;
- decode logits: atol 2e-3 rtol 2e-3 — the same, plus the bf16 cache: a
  K/V value that lands next to a bf16 rounding boundary can round one
  ulp (2^-8 relative) apart on the two sides.
Greedy tokens must be identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import reduce_for_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.models import build_model, cross_entropy  # noqa: E402
from repro_torch.models.convert import to_torch_params  # noqa: E402

PREFILL_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture(scope="module")
def bridged():
    cfg = reduce_for_smoke(CONFIGS["qwen3-4b"])
    jm = jax_build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = t_reduce(get_config("qwen3-4b"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)   # same copy
    tm = build_model(tcfg)
    return (jm, jparams, np_params, tm,
            to_torch_params(np_params, device="cpu"))


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(1, 500, size=(B, S)).astype(
        np.int32)


def test_convert_nested_and_checkpoint_keys_agree(bridged, tmp_path):
    _, _, np_params, tm, tparams = bridged
    save_checkpoint(str(tmp_path / "ck.npz"), np_params)
    flat = dict(np.load(tmp_path / "ck.npz"))
    assert "layers/attn/wq" in flat
    from_flat = to_torch_params(flat, device="cpu")
    fresh = tm.init(torch.Generator().manual_seed(0), "cpu")

    def walk(a, b, c):
        assert set(a) == set(b) == set(c)
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], c[k])
            else:
                torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
                assert a[k].shape == c[k].shape and a[k].dtype == c[k].dtype
    walk(tparams, from_flat, fresh)


def test_forward_and_cross_entropy(bridged):
    jm, jparams, _, tm, tparams = bridged
    toks = _tokens(2, 24)
    jlogits, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    tlogits = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **PREFILL_TOL)
    targets = _tokens(2, 24, seed=1)
    jl, _ = jm.loss(jparams, {"tokens": jnp.asarray(toks),
                              "targets": jnp.asarray(targets)})
    tl, _ = tm.loss(tparams, {"tokens": torch.from_numpy(toks),
                              "targets": torch.from_numpy(targets)})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(
        cross_entropy(tlogits, torch.from_numpy(targets), tm.cfg).item(),
        float(jl), rtol=1e-5)


@pytest.mark.parametrize("max_seq,lens", [(32, (5, 16)), (128, (16, 16))],
                         ids=["linear", "ring"])
def test_prefill_then_greedy_decode_matches(bridged, max_seq, lens):
    """Prefill logits and cache, then 16 greedy decode steps with logits
    and tokens compared at every step."""
    jm, jparams, _, tm, tparams = bridged
    cfg = jm.cfg
    B, S = len(lens), 16
    toks = _tokens(B, S, seed=2)
    lengths = np.asarray(lens, np.int32)
    jlog, jcache = jax.jit(jm.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(toks),
                  "prompt_lengths": jnp.asarray(lengths)}, max_seq)
    jdecode = jax.jit(jm.decode_step)
    tlog, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                        "prompt_lengths": torch.from_numpy(
                                            lengths)}, cache_len=max_seq)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **PREFILL_TOL)
    ring = max_seq > cfg.sliding_window
    assert tcache["k"].shape[2] == (cfg.sliding_window if ring else max_seq)
    np.testing.assert_allclose(tcache["k"].float().numpy(),
                               np.asarray(jcache["k"], np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))
    jtok = jnp.argmax(jlog[:, :cfg.vocab_size], -1).astype(jnp.int32)
    ttok = torch.argmax(tlog[:, :cfg.vocab_size], -1).to(torch.int32)
    for step in range(16):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        active = np.array([True, step % 3 != 2])   # a slot that pauses
        jlog, jcache = jdecode(jparams, jcache, jtok, jnp.asarray(active))
        tlog, tcache = tm.decode_step(tparams, tcache, ttok,
                                      active=torch.from_numpy(active))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **DECODE_TOL)
        np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                      np.asarray(jcache["lengths"]))
        jtok = jnp.argmax(jlog[:, :cfg.vocab_size], -1).astype(jnp.int32)
        ttok = torch.argmax(tlog[:, :cfg.vocab_size], -1).to(torch.int32)
