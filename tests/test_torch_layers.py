"""``repro_torch.models.layers`` / ``attention`` vs the JAX package's, on
the CPU: the same numpy inputs, made from a seed, through both.

f32 on both sides with a different summation order: atol 2e-5 rtol 2e-4
(tests/test_kernels.py's f32 tolerance); bf16 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=2e-4)


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _both(x, bf16=False):
    if bf16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or F32_TOL))


@pytest.mark.parametrize("bf16", [False, True])
def test_norms(bf16):
    jx, tx = _both(_arr((2, 5, 64), 0), bf16)
    js, ts = _both(_arr((64,), 1, 0.1))
    tol = dict(atol=2e-2, rtol=2e-2) if bf16 else F32_TOL
    _close(tlayers.rms_norm(tx, ts, 1e-6), jlayers.rms_norm(jx, js, 1e-6),
           **tol)
    jh, th = _both(_arr((2, 5, 4, 16), 2), bf16)
    jhs, ths = _both(_arr((16,), 3, 0.1))
    _close(tlayers.rms_norm(th, ths), jlayers.head_rms_norm(jh, jhs),
           **tol)


def test_rope_rotates_split_halves():
    jx, tx = _both(_arr((2, 7, 3, 32), 4))
    pos = np.random.default_rng(5).integers(0, 500, size=(2, 7))
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), 1e6)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 1e6)
    _close(got, want, atol=1e-4, rtol=1e-4)   # angles up to 500 rad in f32


def test_projections_and_mlp():
    d, H, KV, hd, f = 32, 4, 2, 8, 48
    p = {"wq": _arr((d, H, hd), 6, 0.2), "wk": _arr((d, KV, hd), 7, 0.2),
         "wv": _arr((d, KV, hd), 8, 0.2), "wo": _arr((H, hd, d), 9, 0.2),
         "q_norm": _arr((hd,), 10, 0.1), "k_norm": _arr((hd,), 11, 0.1)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jx, tx = _both(_arr((2, 5, d), 12))
    for got, want in zip(tlayers.project_qkv(tp, tx, qk_norm=True),
                         jlayers.project_qkv(jp, jx, qk_norm=True)):
        _close(got, want)
    ja, ta = _both(_arr((2, 5, H, hd), 13))
    _close(tlayers.project_out(tp, ta), jlayers.project_out(jp, ja))
    m = {"w_gate": _arr((d, f), 14, 0.2), "w_up": _arr((d, f), 15, 0.2),
         "w_down": _arr((f, d), 16, 0.2)}
    _close(tlayers.mlp_apply({k: torch.from_numpy(v) for k, v in m.items()},
                             tx),
           jlayers.mlp_apply({k: jnp.asarray(v) for k, v in m.items()}, jx))


def test_init_is_truncated_normal_at_fan_in_scale():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init((256, 512), 256, torch.float32, "cpu", gen)
    std = 1.0 / 16
    assert w.abs().max() <= 3 * std + 1e-7
    # a normal truncated at +-3 std keeps ~98.7% of its std
    assert abs(w.std().item() / std - 0.9866) < 0.02
    e = tlayers.embed_init((1000, 64), torch.bfloat16, "cpu", gen)
    assert e.dtype == torch.bfloat16 and e.float().abs().max() <= 0.0601


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 5])
def test_blockwise_attention_kernel_path(window):
    """No explicit positions, no soft-cap: the port dispatches to the flash
    kernel (its plain version on the CPU); JAX runs its eager path."""
    jq, tq = _both(_arr((2, 20, 4, 16), 17))
    jk, tk = _both(_arr((2, 20, 2, 16), 18))
    jv, tv = _both(_arr((2, 20, 2, 16), 19))
    _close(tattn.blockwise_attention(tq, tk, tv, window=window),
           jattn.blockwise_attention(jq, jk, jv, window=window))


def test_blockwise_attention_eager_path_with_positions_and_cap():
    jq, tq = _both(_arr((1, 9, 4, 16), 20))
    jk, tk = _both(_arr((1, 12, 2, 16), 21))
    jv, tv = _both(_arr((1, 12, 2, 16), 22))
    qpos = np.arange(3, 12)[None]
    kpos = np.arange(12)[None]
    got = tattn.blockwise_attention(
        tq, tk, tv, q_positions=torch.from_numpy(qpos),
        kv_positions=torch.from_numpy(kpos), window=6, chunk=4,
        logit_cap=5.0)
    want = jattn.blockwise_attention(
        jq, jk, jv, q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kpos), window=6, chunk=4, logit_cap=5.0)
    _close(got, want)


@pytest.mark.parametrize("ring,cap", [(False, None), (True, None),
                                      (False, 3.0)])
def test_decode_attention_linear_ring_and_cap(ring, cap):
    B, S, H, KV, hd = 3, 16, 4, 2, 16
    jq, tq = _both(_arr((B, H, hd), 23))
    jk, tk = _both(_arr((B, S, KV, hd), 24), bf16=True)
    jv, tv = _both(_arr((B, S, KV, hd), 25), bf16=True)
    lens = np.array([1, 9, 40 if ring else 16], np.int32)
    kw_j, kw_t = {}, {}
    if ring:
        kw_j["kv_positions"] = jattn.ring_positions(jnp.asarray(lens), S)
        kw_t["kv_positions"] = tattn.ring_positions(torch.from_numpy(lens), S)
        np.testing.assert_array_equal(kw_t["kv_positions"].numpy(),
                                      np.asarray(kw_j["kv_positions"]))
    got = tattn.decode_attention(tq, tk, tv, lengths=torch.from_numpy(lens),
                                 logit_cap=cap, **kw_t)
    want = jattn.decode_attention(jq, jk, jv, lengths=jnp.asarray(lens),
                                  logit_cap=cap, **kw_j)
    _close(got, want)


@pytest.mark.parametrize("ring", [False, True])
def test_cache_write_in_place(ring):
    B, S, KV, hd = 3, 8, 2, 4
    kc, vc = _arr((B, S, KV, hd), 26), _arr((B, S, KV, hd), 27)
    kn, vn = _arr((B, KV, hd), 28), _arr((B, KV, hd), 29)
    # the last slot is full: a linear write there is dropped (JAX drops
    # out-of-bounds scatters), a ring write wraps
    lens = np.array([0, 5, S + 3 if ring else S], np.int32)
    jk, jv = jattn.cache_write(jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(lens), ring=ring)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out = tattn.cache_write(tk, tv, torch.from_numpy(kn),
                            torch.from_numpy(vn), torch.from_numpy(lens),
                            ring=ring)
    assert out[0] is tk and out[1] is tv          # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_ring_positions():
    lens = np.array([0, 1, 7, 8, 9, 30], np.int32)
    np.testing.assert_array_equal(
        tattn.ring_positions(torch.from_numpy(lens), 8).numpy(),
        np.asarray(jattn.ring_positions(jnp.asarray(lens), 8)))
