"""The recurrent kernels' plain versions (and flash at head_dim 256) vs the
JAX package's oracles and its Pallas kernels in interpret mode, on the CPU.

The CUDA kernels run only on a GPU (chip_smoke.py holds them against
these plain versions there). Here the same numpy inputs, made from a
seed, go through ``repro.kernels.ref``, the Pallas kernel in interpret
mode, and the port's plain version, wrapper and ``ops`` dispatch.
Tolerances: ``rglru_scan`` and flash at tests/test_kernels.py's f32 atol
1e-5 / rtol 1e-4 and 2e-5 / 2e-4 (one recurrence, summed in the same
order; attention sums in another order); ``wkv_scan`` at its atol 1e-4 /
rtol 1e-3 (an N-term dot product per step, accumulated over T steps).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.rglru import rglru_scan as pallas_rglru  # noqa: E402
from repro.kernels.rwkv6 import wkv_scan as pallas_wkv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rglru import (  # noqa: E402
    ROUND, SEGMENT, WARPS, rglru_scan, rglru_scan_plain)
from repro_torch.kernels.rwkv6 import CHUNK, wkv_scan, wkv_scan_plain  # noqa: E402

RGLRU_TOL = dict(atol=1e-5, rtol=1e-4)
WKV_TOL = dict(atol=1e-4, rtol=1e-3)
FLASH_TOL = dict(atol=2e-5, rtol=2e-4)


def _arr(shape, seed, scale=1.0, lo=None, hi=None):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x = x * scale
    if lo is not None:
        x = np.clip(np.abs(x), lo, hi)
    return x


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x.copy())


@pytest.fixture
def interpret_backend():
    """The JAX ops dispatch in interpret mode, restored even on failure."""
    jops.set_backend("interpret")
    try:
        yield
    finally:
        jops.set_backend("ref")


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,W,bt,bw", [
    (2, 256, 512, 128, 512),
    (1, 256, 1024, 64, 256),
    (4, 128, 256, 128, 256),
])
def test_rglru_plain_matches_pallas_and_ref(B, S, W, bt, bw):
    ja, ta = _both(_arr((B, S, W), 1, lo=0.5, hi=0.999))
    jb, tb = _both(_arr((B, S, W), 2, scale=0.1))
    jh0, th0 = _both(_arr((B, W), 3, scale=0.1))
    want = np.asarray(ref.rglru_ref(ja, jb, jh0))
    ph, plast = pallas_rglru(ja, jb, jh0, bt=bt, bw=bw, interpret=True)
    h, last = rglru_scan_plain(ta, tb, th0)
    np.testing.assert_allclose(h.numpy(), want, **RGLRU_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ph), **RGLRU_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(plast), **RGLRU_TOL)
    np.testing.assert_allclose(last.numpy(), want[:, -1], **RGLRU_TOL)


@pytest.mark.parametrize("S", [1, 77, 200])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_ops_ragged_matches_jax_ops(interpret_backend, S, with_h0):
    """S not a multiple of the Pallas block: JAX pads with a = b = 0 and
    reads h_last at S - 1; the port pads nothing."""
    B, W = 2, 256
    ja, ta = _both(_arr((B, S, W), 4, lo=0.5, hi=0.999))
    jb, tb = _both(_arr((B, S, W), 5, scale=0.1))
    jh0, th0 = _both(_arr((B, W), 6, scale=0.1))
    jh, jlast = jops.rglru_scan(ja, jb, jh0 if with_h0 else None)
    n0 = rglru_scan.launches
    h, last = ops.rglru_scan(ta, tb, th0 if with_h0 else None)
    assert rglru_scan.launches == n0        # CPU tensors: no kernel
    assert h.shape == (B, S, W) and last.shape == (B, W)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **RGLRU_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **RGLRU_TOL)


def test_rglru_empty_sequence_keeps_h0():
    h0 = torch.from_numpy(_arr((2, 8), 7))
    h, last = rglru_scan(torch.zeros(2, 0, 8), torch.zeros(2, 0, 8), h0)
    assert h.shape == (2, 0, 8)
    torch.testing.assert_close(last, h0, rtol=0, atol=0)


def _rglru_rounds(a, b, h0, K, NW, repair=True):
    """A plain mirror of the scan in ``csrc/rglru.cu`` (tests only): rounds
    of nw segments of K steps, nw the least power of two with nw K >= S, at
    most NW (steps past S are the identity a = 1, b = 0). In each round,
    (1) every segment's pair (A, B) from a zero state, A the product of its
    a's; (2) the nw pairs scanned in the kernel's shuffle order, a later
    (A, B) after an earlier (A', B') giving (A A', A B' + B), and the carry
    applied to give each segment's start state and the next carry; with
    ``repair``, a channel whose segment ends hold a NaN has its round's
    start states and carry walked again in series from the carry; (3)
    each segment's steps replayed from its start state."""
    B, S, W = a.shape
    nw = 1
    while nw < NW and nw * K < S:
        nw *= 2
    R = K * nw
    n = -(-S // R) * R
    ap, bp = torch.ones(B, n, W), torch.zeros(B, n, W)
    ap[:, :S], bp[:, :S] = a, b
    carry = torch.zeros(B, W) if h0 is None else h0.clone()
    h = torch.empty(B, n, W)
    steps = torch.arange(nw) * K
    for t0 in range(0, n, R):
        ar = ap[:, t0:t0 + R].reshape(B, nw, K, W)
        br = bp[:, t0:t0 + R].reshape(B, nw, K, W)
        ca, cb = ar[:, :, 0], br[:, :, 0]                   # (1)
        for u in range(1, K):
            ca, cb = ca * ar[:, :, u], ar[:, :, u] * cb + br[:, :, u]
        off = 1                                             # (2)
        while off < nw:
            na, nb = ca.clone(), cb.clone()
            nb[:, off:] = ca[:, off:] * cb[:, :-off] + cb[:, off:]
            na[:, off:] = ca[:, off:] * ca[:, :-off]
            ca, cb, off = na, nb, 2 * off
        end = ca * carry[:, None] + cb
        hv = torch.cat([carry[:, None], end[:, :-1]], dim=1)
        if repair and torch.isnan(end).any():
            bad, starts, x = torch.isnan(end).any(1), [], carry
            for j in range(nw):
                starts.append(x)
                for u in range(K):
                    x = ar[:, j, u] * x + br[:, j, u]
            hv = torch.where(bad[:, None], torch.stack(starts, 1), hv)
            end[:, -1] = torch.where(bad, x, end[:, -1])
        carry = end[:, -1]
        for u in range(K):                                  # (3)
            hv = ar[:, :, u] * hv + br[:, :, u]
            h[:, t0 + steps + u] = hv
    return h[:, :S], carry


def _decays(shape, draw, seed):
    """a for the RG-LRU tests: [0.5, 0.999] (the first version's draw),
    the model's range exp(-8 softplus(lam) r) for lam in its init span
    [0.3, 1.5] and r in (0, 1) (``models/rglru.py::_gates``), or [0, 1]
    with exact zeros and ones (a tenth each: the kernel's contract)."""
    rng = np.random.default_rng(seed)
    if draw == "[0.5, 0.999]":
        return rng.uniform(0.5, 0.999, size=shape).astype(np.float32)
    if draw == "model range":
        lam = rng.uniform(0.3, 1.5, size=shape)
        r = rng.uniform(0.0, 1.0, size=shape)
        return np.exp(-8.0 * np.log1p(np.exp(lam)) * r).astype(np.float32)
    return _w_with_zeros_and_ones(shape, seed)


def test_rglru_segment_and_round_are_the_kernels():
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "kernels" / "csrc" / "rglru.cu").read_text()
    assert f"constexpr int K = {SEGMENT};" in src
    assert f"constexpr int NW = {WARPS};" in src
    assert ROUND == SEGMENT * WARPS


RGLRU_DRAWS = ["[0.5, 0.999]", "model range", "[0, 1] with 0 and 1"]


@pytest.mark.parametrize("S", [SEGMENT - 1, SEGMENT, SEGMENT + 1, ROUND - 1,
                               ROUND, ROUND + 1])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("draw", RGLRU_DRAWS)
def test_rglru_round_algebra_matches_ref_and_pallas(interpret_backend, S,
                                                    with_h0, draw):
    """The kernel's segments and rounds at their edges, against
    ``ref.rglru_ref`` and the Pallas kernel in interpret mode (through the
    JAX ``ops``, which pads S), at a ragged W (not a multiple of 32)."""
    B, W = 2, 40
    a = _decays((B, S, W), draw, 60 + S)
    if draw == "[0, 1] with 0 and 1":
        assert (a == 0).any() and (a == 1).any()
    b, h0 = _arr((B, S, W), 61, scale=0.1), _arr((B, W), 62, scale=0.1)
    h0 = h0 if with_h0 else None
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = np.asarray(ref.rglru_ref(ja, jb, jh0))
    ph, plast = jops.rglru_scan(ja, jb, jh0)
    h, last = _rglru_rounds(torch.from_numpy(a), torch.from_numpy(b),
                            None if h0 is None else torch.from_numpy(h0),
                            SEGMENT, WARPS)
    for got, ref_h, ref_last in ((h, want, want[:, -1]),
                                 (h, np.asarray(ph), np.asarray(plast))):
        np.testing.assert_allclose(got.numpy(), ref_h, **RGLRU_TOL)
        np.testing.assert_allclose(last.numpy(), ref_last, **RGLRU_TOL)


@pytest.mark.parametrize("K,NW", [(1, 1), (2, 4), (4, 32), (16, 16)])
def test_rglru_round_algebra_at_other_variants(K, NW):
    """Many rounds: the mirror at short rounds and at other segment lengths
    and warp counts (K = 4 with 32 warps, K = 16 with 16) equals the
    sequential plain version, a with exact 0 and 1, with h0."""
    B, S, W = 2, 300, 8
    a = torch.from_numpy(_decays((B, S, W), "[0, 1] with 0 and 1", 70))
    b, h0 = (torch.from_numpy(_arr(s, seed, scale=0.1))
             for s, seed in (((B, S, W), 71), ((B, W), 72)))
    h, last = _rglru_rounds(a, b, h0, K, NW)
    ph, plast = rglru_scan_plain(a, b, h0)
    np.testing.assert_allclose(h.numpy(), ph.numpy(), **RGLRU_TOL)
    np.testing.assert_allclose(last.numpy(), plast.numpy(), **RGLRU_TOL)


def test_rglru_round_algebra_keeps_infinities_where_the_steps_do():
    """An Inf in b: the mirror's output is +Inf, -Inf and NaN exactly where
    the sequential plain version's is (a in [0.5, 0.999], where no product
    over a round underflows to 0), and equal elsewhere."""
    B, S, W = 1, 2 * ROUND + 3, 6
    a = torch.from_numpy(_decays((B, S, W), "[0.5, 0.999]", 80))
    b = torch.from_numpy(_arr((B, S, W), 81, scale=0.1))
    b[0, 5, 0] = np.inf                     # +Inf from an early step on
    b[0, ROUND + 9, 1] = -np.inf            # -Inf in the second round
    b[0, 17, 2], b[0, ROUND + 30, 2] = np.inf, -np.inf      # NaN after both
    h, last = _rglru_rounds(a, b, None, SEGMENT, WARPS)
    ph, plast = rglru_scan_plain(a, b)
    for got, want in ((h, ph), (last, plast)):
        for cls in (torch.isposinf, torch.isneginf, torch.isnan):
            assert torch.equal(cls(got), cls(want))
        fin = torch.isfinite(want)
        np.testing.assert_allclose(got[fin].numpy(), want[fin].numpy(),
                                   **RGLRU_TOL)
    assert torch.isnan(ph[0, -1, 2]) and torch.isposinf(ph[0, -1, 0])


@pytest.mark.parametrize("draw", ["model range", "[0, 1] with 0 and 1"])
def test_rglru_round_repair_keeps_infinities_in_every_draw(draw):
    """An Inf in b where products of a over a round underflow to 0 (the
    model's range) or hold exact zeros: the pairs alone give NaN where the
    steps keep Inf, and the kernel's walk in series of such a channel's
    round puts +Inf, -Inf and NaN exactly where the sequential plain
    version has them, and equal values elsewhere."""
    B, S, W = 1, 2 * ROUND + 3, 6
    a = torch.from_numpy(_decays((B, S, W), draw, 82))
    b = torch.from_numpy(_arr((B, S, W), 83, scale=0.1))
    b[0, 5, 0] = np.inf
    b[0, ROUND + 9, 1] = -np.inf
    b[0, 17, 2], b[0, ROUND + 30, 2] = np.inf, -np.inf
    b[0, 3 * SEGMENT, 4] = np.inf
    ph, plast = rglru_scan_plain(a, b)
    h, last = _rglru_rounds(a, b, None, SEGMENT, WARPS)
    for got, want in ((h, ph), (last, plast)):
        for cls in (torch.isposinf, torch.isneginf, torch.isnan):
            assert torch.equal(cls(got), cls(want))
        fin = torch.isfinite(want)
        np.testing.assert_allclose(got[fin].numpy(), want[fin].numpy(),
                                   **RGLRU_TOL)
    if draw == "model range":
        bare, _ = _rglru_rounds(a, b, None, SEGMENT, WARPS, repair=False)
        assert (torch.isnan(bare) & torch.isposinf(ph)).any()


# ---------------------------------------------------------------------------
# wkv_scan
# ---------------------------------------------------------------------------

def _wkv_inputs(B, T, H, N, seed=10):
    """r/k/v/w [B, T, H, N], u [H, N], s0 [B, H, N, N] as numpy."""
    return (_arr((B, T, H, N), seed), _arr((B, T, H, N), seed + 1, 0.2),
            _arr((B, T, H, N), seed + 2),
            _arr((B, T, H, N), seed + 3, lo=0.9, hi=0.999),
            _arr((H, N), seed + 4), _arr((B, H, N, N), seed + 5, 0.1))


@pytest.mark.parametrize("B,T,H,N,bt", [
    (2, 256, 4, 64, 128),
    (1, 128, 2, 128, 64),
    (3, 64, 8, 64, 64),
])
def test_wkv_plain_matches_pallas_and_ref(B, T, H, N, bt):
    r, k, v, w, u, s0 = _wkv_inputs(B, T, H, N)
    jr, jk, jv, jw, ju, js0 = (jnp.asarray(x) for x in (r, k, v, w, u, s0))
    y_ref, s_ref = ref.rwkv6_ref(jr, jk, jv, jw, ju, js0)
    tr = lambda t: jnp.swapaxes(t, 1, 2)        # noqa: E731
    py, ps = pallas_wkv(tr(jr), tr(jk), tr(jv), tr(jw), ju, js0, bt=bt,
                        interpret=True)
    y, s = wkv_scan_plain(*(torch.from_numpy(x) for x in (r, k, v, w, u,
                                                          s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **WKV_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(tr(py)), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), **WKV_TOL)


@pytest.mark.parametrize("T", [1, 50, 130])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_ops_ragged_matches_jax_ops(interpret_backend, T, with_s0):
    """A ragged T through both ``ops``: JAX transposes and pads with w = 1,
    k = 0; the port takes ``[B, T, H, N]`` as it is."""
    r, k, v, w, u, s0 = _wkv_inputs(2, T, 2, 64, seed=20)
    jy, js = jops.wkv_scan(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                           jnp.asarray(s0) if with_s0 else None)
    n0 = wkv_scan.launches
    y, s = ops.wkv_scan(*(torch.from_numpy(x) for x in (r, k, v, w, u)),
                        torch.from_numpy(s0) if with_s0 else None)
    assert wkv_scan.launches == n0          # CPU tensors: no kernel
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **WKV_TOL)


def _wkv_three_pass(r, k, v, w, u, s0, L):
    """A plain mirror of the chunked scan in ``csrc/rwkv6.cu`` (tests only):
    (a) each chunk's sequential step from S = 0 (chunk 0 from s0), giving
    y_loc (its u term as ``v * r.(u*k)``), the chunk's state dS_c and its
    decay product D_c; (b) the chunks' start states in order, S_{c+1} =
    D_c * S_c + dS_c from S_1 = dS_0, the last one s_final; (c) for chunks
    c >= 1, y_t += (r_t * W_t) . S_c with W_t the running product of w over
    the chunk's earlier steps. Products of w only, no logarithms."""
    B, T, H, N = r.shape
    nc = -(-T // L)
    y = torch.empty_like(r)
    d_state, decay = [], []
    for c in range(nc):                                     # (a)
        s = s0.clone() if c == 0 and s0 is not None else \
            torch.zeros(B, H, N, N)
        d = torch.ones(B, H, N)
        for t in range(c * L, min(T, (c + 1) * L)):
            ruk = (r[:, t] * u * k[:, t]).sum(-1, keepdim=True)
            y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t], s) + \
                v[:, t] * ruk
            s = w[:, t, :, :, None] * s + \
                k[:, t, :, :, None] * v[:, t, :, None, :]
            d = d * w[:, t]
        d_state.append(s)
        decay.append(d)
    if nc == 0:                                             # (b)
        return y, torch.zeros(B, H, N, N) if s0 is None else s0.clone()
    starts, state = [None], d_state[0]
    for c in range(1, nc):
        starts.append(state)
        state = decay[c][..., None] * state + d_state[c]
    for c in range(1, nc):                                  # (c)
        W = torch.ones(B, H, N)
        for t in range(c * L, min(T, (c + 1) * L)):
            y[:, t] += torch.einsum("bhi,bhij->bhj", r[:, t] * W, starts[c])
            W = W * w[:, t]
    return y, state


def _w_with_zeros_and_ones(shape, seed):
    """w in [0, 1] with exact zeros and ones among the draws (a tenth each):
    the kernel's contract, wider than the model's clamped range."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    pick = rng.uniform(size=shape)
    w[pick < 0.1] = 0.0
    w[pick > 0.9] = 1.0
    return w


def test_chunk_length_is_the_kernels():
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "kernels" / "csrc" / "rwkv6.cu").read_text()
    assert f"constexpr int L = {CHUNK};" in src


@pytest.mark.parametrize("T", [CHUNK - 24, CHUNK, 3 * CHUNK + 5])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_chunk_algebra_matches_ref_and_pallas(interpret_backend, T,
                                                   with_s0):
    """The chunked scan's three passes at the kernel's chunk length, at the
    chunk edges (T < L, T = L, T = 3L + 5) and with w holding exact 0 and
    1, against ``ref.rwkv6_ref`` and the Pallas kernel in interpret mode
    (through the JAX ``ops``, which pads T)."""
    B, H, N = 2, 2, 64
    r, k, v, _, u, s0 = _wkv_inputs(B, T, H, N, seed=40)
    w = _w_with_zeros_and_ones((B, T, H, N), 46)
    assert (w == 0).any() and (w == 1).any()
    s0 = s0 if with_s0 else None
    j = [jnp.asarray(x) for x in (r, k, v, w, u)]
    js0 = jnp.asarray(s0) if with_s0 else jnp.zeros((B, H, N, N))
    y_ref, s_ref = ref.rwkv6_ref(*j, js0)
    py, ps = jops.wkv_scan(*j, None if s0 is None else js0)
    y, s = _wkv_three_pass(*(torch.from_numpy(x) for x in (r, k, v, w, u)),
                           None if s0 is None else torch.from_numpy(s0),
                           CHUNK)
    for got, want in ((y, y_ref), (s, s_ref), (y, py), (s, ps)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **WKV_TOL)


@pytest.mark.parametrize("L", [1, 4, 7])
def test_wkv_chunk_algebra_at_short_chunks(L):
    """Many chunk edges: the three passes at short chunks (L = 1 makes every
    step its own chunk) equal the sequential plain version, w with exact 0
    and 1, with s0."""
    B, T, H, N = 1, 23, 2, 64
    r, k, v, _, u, s0 = _wkv_inputs(B, T, H, N, seed=50)
    w = _w_with_zeros_and_ones((B, T, H, N), 56)
    args = [torch.from_numpy(x) for x in (r, k, v, w, u, s0)]
    y, s = _wkv_three_pass(*args, L)
    py, ps = wkv_scan_plain(*args)
    np.testing.assert_allclose(y.numpy(), py.numpy(), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), ps.numpy(), **WKV_TOL)


def test_wrappers_refuse_mixed_devices():
    a = torch.zeros(1, 4, 8)
    meta = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        rglru_scan(a, meta)
    x = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="one CUDA device"):
        wkv_scan(x, x, x, x.to("meta"), torch.zeros(2, 64))


# ---------------------------------------------------------------------------
# flash attention at head_dim 256 (RecurrentGemma's local attention)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,window", [(128, 32), (96, 128), (64, None)])
def test_flash_hd256_mqa_window_matches_pallas(S, window):
    """16 query heads on one KV head at hd 256, causal, with the local
    window (and without): the plain version against the Pallas kernel in
    interpret mode, through both ``ops`` paddings. Every causal row sees
    its own key, so no row is fully masked."""
    B, H, KV, hd = 1, 16, 1, 256
    jq, tq = _both(_arr((B, H, S, hd), 30))
    jk, tk = _both(_arr((B, KV, S, hd), 31))
    jv, tv = _both(_arr((B, KV, S, hd), 32))
    want = pallas_flash(jq, jk, jv, causal=True, window=window, bq=32,
                        bkv=32, interpret=True)
    got = flash_attention_plain(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    via_ops = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(via_ops.numpy(), np.asarray(want),
                               **FLASH_TOL)
    oracle = ref.attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **FLASH_TOL)
