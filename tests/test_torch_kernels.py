"""Port kernels' plain versions vs the JAX package's oracles and its Pallas
kernels (interpret mode), on the CPU.

The CUDA kernels themselves run only on a GPU (chip_smoke.py holds them
against these plain versions there). Here the same
numpy inputs, made from a seed, go through ``repro.kernels.ref``, the
Pallas kernel in interpret mode, and the port's plain version / wrapper /
``ops`` dispatch. Tolerances are tests/test_kernels.py's: f32 atol 2e-5
rtol 2e-4, bf16 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    TILE, decode_attention, decode_attention_plain, decode_splits)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-4)


def _pair(shape, seed, name="float32", scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def interpret_backend():
    """The JAX ops dispatch in interpret mode, restored even on failure
    (xdist runs several files in one process)."""
    jops.set_backend("interpret")
    try:
        yield
    finally:
        jops.set_backend("ref")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _tf32_rna(x):
    """f32 -> TF32 rounded to nearest, ties away (``tf32_mma.cuh``'s integer
    add and mask)."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tf32_trunc(x):
    """What an MMA reads of an f32 operand: its top 19 bits."""
    b = x.astype(np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def test_flash_pv_fragments_cover_each_key_once():
    """The flash kernel feeds P to the second MMA from its score
    accumulators: lane (g, t) holds columns 2t, 2t + 1 of each n8 tile and
    hands them over as A's k = t, t + 4; V's B fragment comes from key rows
    2t, 2t + 1. One m16n8k8 tile, lane by lane, in the hardware's operand
    layout: the product is P V."""
    rng = np.random.default_rng(60)
    P, V = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))
    A, B = np.full((16, 8), np.nan), np.full((8, 8), np.nan)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        acc = (P[g, 2 * t], P[g, 2 * t + 1], P[g + 8, 2 * t],
               P[g + 8, 2 * t + 1])                 # the score accumulator
        a = (acc[0], acc[2], acc[1], acc[3])        # the kernel's order
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a
        B[t, g], B[t + 4, g] = V[2 * t, g], V[2 * t + 1, g]
    assert not np.isnan(A).any() and not np.isnan(B).any()
    np.testing.assert_allclose(A @ B, P @ V, rtol=1e-12, atol=1e-12)


def test_3xtf32_split_keeps_f32_accuracy():
    """hi = rna(v), lo = v - hi read by the MMA from its top 19 bits, and
    a_lo b_hi + a_hi b_lo + a_hi b_hi over one 32-deep slice: within a few
    f32 roundings of the f64 product, where one TF32 product is not."""
    rng = np.random.default_rng(61)
    a = rng.normal(size=(16, 32)).astype(np.float32)
    b = rng.normal(size=(32, 8)).astype(np.float32)
    ahi, bhi = _tf32_rna(a), _tf32_rna(b)
    alo, blo = _tf32_trunc(a - ahi), _tf32_trunc(b - bhi)
    f64 = lambda x: x.astype(np.float64)           # noqa: E731
    three = f64(alo) @ f64(bhi) + f64(ahi) @ f64(blo) + f64(ahi) @ f64(bhi)
    exact = f64(a) @ f64(b)
    scale = np.abs(f64(a)) @ np.abs(f64(b))
    assert np.max(np.abs(three - exact) / scale) < 2 ** -20
    one = f64(_tf32_trunc(a)) @ f64(_tf32_trunc(b))
    assert np.max(np.abs(one - exact) / scale) > 2 ** -14


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,causal,window,q_offset", [
    (2, 4, 2, 48, 48, 64, True, None, 0),      # GQA causal
    (1, 4, 1, 32, 80, 32, True, None, 48),     # MQA, q block at an offset
    (1, 4, 4, 40, 40, 64, False, None, 0),     # MHA bidirectional
    (1, 2, 2, 64, 64, 64, True, 17, 0),        # sliding window
])
def test_flash_plain_matches_ref(B, H, KV, Sq, Skv, hd, causal, window,
                                 q_offset, name):
    jq, tq = _pair((B, H, Sq, hd), 1, name)
    jk, tk = _pair((B, KV, Skv, hd), 2, name)
    jv, tv = _pair((B, KV, Skv, hd), 3, name)
    want = ref.attention_ref(jq, jk, jv, causal=causal, window=window,
                             q_offset=q_offset)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                q_offset=q_offset)
    assert got.dtype == DTYPES[name][1]
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("causal,window,kv_len,q_offset", [
    (True, None, 128, 0),
    (True, None, 100, 0),       # padded key columns masked by kv_len
    (False, None, 77, 0),
    (True, 50, 128, 0),
    (True, 160, 128, 64),       # query block at an offset
])
def test_flash_plain_matches_pallas_interpret(causal, window, kv_len,
                                              q_offset):
    B, H, KV, S, hd = 1, 4, 2, 128, 64
    jq, tq = _pair((B, H, S, hd), 4)
    jk, tk = _pair((B, KV, S, hd), 5)
    jv, tv = _pair((B, KV, S, hd), 6)
    want = pallas_flash(jq, jk, jv, causal=causal, window=window,
                        q_offset=q_offset, kv_len=kv_len, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


def test_flash_fully_masked_rows_are_zero():
    """A row with no visible key gives 0, as kernels/ref.py:31-33 defines
    (the Pallas kernel diverges here: its rows average V; ROADMAP Queue 3)."""
    B, H, KV, S, hd = 1, 2, 1, 16, 32
    jq, tq = _pair((B, H, S, hd), 7)
    jk, tk = _pair((B, KV, S, hd), 8)
    jv, tv = _pair((B, KV, S, hd), 9)
    # q positions 40..55 with a window of 4 see no key of 0..15
    want = ref.attention_ref(jq, jk, jv, causal=True, window=4, q_offset=40)
    got = flash_attention_plain(tq, tk, tv, causal=True, window=4,
                                q_offset=40)
    assert not np.asarray(want).any()
    np.testing.assert_array_equal(_np(got), np.zeros((B, H, S, hd)))
    # kv_len masking: rows past kv_len + window - 1 have nothing left
    got = flash_attention_plain(tq, tk, tv, causal=True, window=4, kv_len=8)
    assert not _np(got)[:, :, 11:].any() and _np(got)[:, :, :11].any()


@pytest.mark.parametrize("Sq,causal,window", [(100, True, None),
                                              (100, False, None),
                                              (16, True, 64),
                                              (130, True, 40)])
def test_flash_ops_padding_matches_jax_ops(Sq, causal, window,
                                           interpret_backend):
    """ops pads Sq/Skv to the block and masks padded keys by kv_len —
    the JAX ops wrapper (interpret backend) and the port agree."""
    jq, tq = _pair((1, 4, Sq, 64), 10)
    jk, tk = _pair((1, 2, Sq, 64), 11)
    jv, tv = _pair((1, 2, Sq, 64), 12)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (1, 4, Sq, 64)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

BS = 8          # small Pallas block so lengths straddle block boundaries


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", [
    (1, BS - 1, BS),              # inside / at the first block boundary
    (BS + 1, 2 * BS, 2 * BS + 1),  # straddling the second
    (63, 64, 1),                  # full cache next to a near-empty one
])
def test_decode_plain_matches_ref_and_pallas(lens, name):
    B, H, KV, hd, S = len(lens), 4, 2, 16, 64
    jq, tq = _pair((B, H, hd), 13, name)
    jk, tk = _pair((B, S, KV, hd), 14, name)
    jv, tv = _pair((B, S, KV, hd), 15, name)
    jl = jnp.asarray(lens, jnp.int32)
    tl = torch.tensor(lens, dtype=torch.int32)
    got = decode_attention_plain(tq, tk, tv, tl)
    np.testing.assert_allclose(
        _np(got), _np(ref.decode_attention_ref(jq, jk, jv, jl)), **_tol(name))
    np.testing.assert_allclose(
        _np(got), _np(pallas_decode(jq, jk, jv, jl, bs=BS, interpret=True)),
        **_tol(name))


def test_decode_mixed_types_match_jax_ops(interpret_backend):
    """The main path's types: f32 q against a bf16 cache, through both
    packages' ops dispatch (S not a multiple of the JAX block: JAX pads,
    the port does not need to)."""
    B, H, KV, hd, S = 3, 8, 2, 64, 100
    jq, tq = _pair((B, H, hd), 16)
    jk, tk = _pair((B, S, KV, hd), 17, "bfloat16")
    jv, tv = _pair((B, S, KV, hd), 18, "bfloat16")
    lens = (1, 37, 100)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens, jnp.int32))
    got = ops.decode_attention(tq, tk, tv, torch.tensor(lens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


def test_decode_poisoned_past_length_is_exact():
    """Entries past each length must not perturb the output at all."""
    B, H, KV, hd, S = 2, 2, 1, 16, 64
    _, q = _pair((B, H, hd), 19)
    _, k = _pair((B, S, KV, hd), 20)
    _, v = _pair((B, S, KV, hd), 21)
    lengths = torch.tensor([BS, 3 * BS], dtype=torch.int32)
    base = decode_attention(q, k, v, lengths)
    past = torch.arange(S)[None, :, None, None] >= lengths[:, None, None, None]
    out = decode_attention(q, torch.where(past, 1e9, k),
                           torch.where(past, -1e9, v), lengths)
    torch.testing.assert_close(out, base, rtol=0, atol=0)


@pytest.mark.parametrize("B,KV,S,n_sm,want", [
    # the main path (4 slots, 8 KV heads, 2048 positions): 256 blocks, two
    # per SM, the split chip_smoke.py's sweep found fastest
    (4, 8, 2048, 132, (256, 8)),
    (1, 8, 2048, 132, (64, 32)),
    (64, 8, 2048, 132, (2048, 1)),
    (128, 8, 2048, 132, (2048, 1)),  # enough blocks without a split
    (3, 2, 48, 132, (32, 2)),
    (2, 1, 300, 132, (32, 10)),
    # served with fewer slots or a longer cache (the split never depends
    # on the lengths, only on B, KV and S)
    (2, 8, 2048, 132, (128, 16)),
    (3, 8, 2048, 132, (192, 11)),
    (4, 8, 4096, 132, (480, 9)),
])
def test_decode_splits_cover_the_cache(B, KV, S, n_sm, want):
    split_len, nsplit = decode_splits(B, KV, S, n_sm)
    assert (split_len, nsplit) == want
    assert split_len % TILE == 0
    assert split_len * nsplit >= S > split_len * (nsplit - 1)


# ---------------------------------------------------------------------------
# dispatch by device
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_version_only_on_cpu():
    _, q = _pair((1, 2, 64, 32), 22)
    _, k = _pair((1, 1, 64, 32), 23)
    before = (flash_attention.launches, decode_attention.launches)
    torch.testing.assert_close(flash_attention(q, k, k),
                               flash_attention_plain(q, k, k))
    lengths = torch.tensor([5])
    kc = k.transpose(1, 2).contiguous().to(torch.bfloat16)
    torch.testing.assert_close(decode_attention(q[:, :, 0], kc, kc, lengths),
                               decode_attention_plain(q[:, :, 0], kc, kc,
                                                      lengths))
    # the plain version is not a launch
    assert (flash_attention.launches, decode_attention.launches) == before
    # a tensor that is neither on the CPU nor on CUDA raises
    meta = torch.empty((1, 2, 64, 32), device="meta")
    with pytest.raises(ValueError):
        flash_attention(meta, meta[:, :1], meta[:, :1])
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], kc, kc, lengths.to("meta"))
