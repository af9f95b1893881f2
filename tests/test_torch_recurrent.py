"""The port's recurrent modules (``models/rglru.py``, ``models/rwkv6.py``)
against the JAX package's on the CPU, on the same (bridged) parameters and
the same seeded numpy inputs, and step-against-scan consistency inside
the port (``tests/test_recurrent.py`` is the template).

Tolerances and their reasons: f32 on both sides, products summed in
another order — atol 1e-5 / rtol 1e-4 for the gates, the conv and the
recurrent block; atol 1e-4 / rtol 1e-3 for the WKV paths (an N-term sum
per step, accumulated over the sequence, and the chunked form's
exp/log reassociation); step against scan at test_recurrent.py's 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import flags as jflags  # noqa: E402
from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import reduce_for_smoke  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch import flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.models import rglru, rwkv6  # noqa: E402
from repro_torch.models.convert import to_torch_params  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
WKV_TOL = dict(atol=1e-4, rtol=1e-3)
STEP_TOL = dict(atol=2e-4, rtol=2e-4)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _x(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _bridge(jparams):
    return to_torch_params(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


@pytest.fixture(scope="module")
def hybrid():
    cfg = reduce_for_smoke(CONFIGS["recurrentgemma-9b"])
    jp = jrglru.rglru_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    return cfg, t_reduce(get_config("recurrentgemma-9b")), jp, _bridge(jp)


@pytest.fixture(scope="module")
def ssm():
    cfg = reduce_for_smoke(CONFIGS["rwkv6-7b"])
    tm = jrwkv.rwkv_time_mix_init(jax.random.PRNGKey(4), cfg, jnp.float32)
    cm = jrwkv.rwkv_channel_mix_init(jax.random.PRNGKey(5), cfg, jnp.float32)
    return (cfg, t_reduce(get_config("rwkv6-7b")), (tm, cm),
            (_bridge(tm), _bridge(cm)))


@pytest.fixture
def chunked_wkv_off():
    """The sequential WKV on both sides, restored even on failure."""
    jflags.set_flag("chunked_wkv", False)
    flags.set_flag("chunked_wkv", False)
    try:
        yield
    finally:
        jflags.set_flag("chunked_wkv", True)
        flags.set_flag("chunked_wkv", True)


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------

def test_rglru_init_shapes_match(hybrid):
    cfg, tcfg, jp, _ = hybrid
    fresh = rglru.rglru_init(tcfg, torch.float32, "cpu",
                             torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    # constants: linspace may round its last bit apart in the two libraries
    for name in ("lam", "conv_b", "gate_a_b", "gate_x_b"):
        np.testing.assert_allclose(fresh[name].numpy(), np.asarray(jp[name]),
                                   atol=1e-6, rtol=1e-6)
    stacked = rglru.rglru_init(tcfg, torch.float32, "cpu", None, lead=(3,))
    assert stacked["lam"].shape == (3, cfg.lru_width)
    np.testing.assert_array_equal(stacked["lam"][2].numpy(),
                                  fresh["lam"].numpy())


def test_gates_conv_and_scan_match(hybrid):
    cfg, _, jp, tp = hybrid
    jx, tx = _x((2, 21, cfg.lru_width), 1)
    for j, t in zip(jrglru._gates(jp, jx), rglru._gates(tp, tx)):
        np.testing.assert_allclose(_np(t), _np(j), **TOL)
    np.testing.assert_allclose(_np(rglru.conv1d_scan(tp, tx)),
                               _np(jrglru.conv1d_scan(jp, jx)), **TOL)
    # the JAX CPU path is the associative scan; the port's the sequential
    np.testing.assert_allclose(_np(rglru.rglru_scan(tp, tx)),
                               _np(jrglru.rglru_scan(jp, jx)), **TOL)


def test_gelu_is_the_tanh_approximation():
    jx, tx = _x((64,), 2, 3.0)
    np.testing.assert_allclose(_np(rglru.gelu(tx)), _np(jax.nn.gelu(jx)),
                               atol=1e-6, rtol=1e-6)


def test_recurrent_block_apply_and_step_match(hybrid):
    cfg, tcfg, jp, tp = hybrid
    jx, tx = _x((2, 12, cfg.d_model), 3)
    jy, jst = jrglru.recurrent_block_apply(jp, jx, return_state=True)
    ty, tst = rglru.recurrent_block_apply(tp, tx, return_state=True)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(_np(tst[key]), _np(jst[key]), **TOL)
    jx1, tx1 = _x((2, cfg.d_model), 4)
    jy1, jst1 = jrglru.recurrent_block_step(jp, jx1, jst)
    ty1, tst1 = rglru.recurrent_block_step(tp, tx1, tst)
    np.testing.assert_allclose(_np(ty1), _np(jy1), **TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(_np(tst1[key]), _np(jst1[key]), **TOL)
    init = rglru.recurrent_state_init(tcfg, 2, "cpu")
    jinit = jrglru.recurrent_state_init(cfg, 2)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in jinit.items()}


def test_rglru_block_step_matches_scan(hybrid):
    """Within the port: S decode steps from the zero state give the scan's
    outputs and its final state."""
    _, tcfg, _, tp = hybrid
    _, tx = _x((2, 10, tcfg.d_model), 5)
    y_scan, state = rglru.recurrent_block_apply(tp, tx, return_state=True)
    st = rglru.recurrent_state_init(tcfg, 2, "cpu")
    ys = []
    for t in range(tx.shape[1]):
        y_t, st = rglru.recurrent_block_step(tp, tx[:, t], st)
        ys.append(y_t)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y_scan),
                               **STEP_TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(_np(st[key]), _np(state[key]),
                                   **STEP_TOL)


def test_rglru_decay_bounded(hybrid):
    """RG-LRU is contractive: with zero input the state decays."""
    _, tcfg, _, tp = hybrid
    h = torch.ones(1, tcfg.lru_width)
    for _ in range(50):
        h, _ = rglru.rglru_step(tp, torch.zeros(1, tcfg.lru_width), h)
    assert h.abs().max().item() < 1.0


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

def test_rwkv_init_shapes_match(ssm):
    cfg, tcfg, (jtm, jcm), _ = ssm
    gen = torch.Generator().manual_seed(0)
    tm = rwkv6.rwkv_time_mix_init(tcfg, torch.float32, "cpu", gen)
    cm = rwkv6.rwkv_channel_mix_init(tcfg, torch.float32, "cpu", gen)
    for fresh, ref in ((tm, jtm), (cm, jcm)):
        assert {k: tuple(v.shape) for k, v in fresh.items()} == \
            {k: tuple(v.shape) for k, v in ref.items()}
    for name in ("decay_base", "bonus_u", "ln_out", "mu_x"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jtm[name]),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("S", [1, 9, 40])
@pytest.mark.parametrize("chunked", [True, False])
def test_time_mix_apply_matches(ssm, S, chunked, request):
    """Prefill time-mix with a carried state and token-shift input: the
    chunked WKV (S > 1, flag on) or the sequential scan, both sides."""
    if not chunked:
        request.getfixturevalue("chunked_wkv_off")
    cfg, tcfg, (jtm, _), (ttm, _) = ssm
    B, d = 2, cfg.d_model
    H, N = cfg.num_heads, cfg.rwkv_head_dim
    jx, tx = _x((B, S, d), 6, 0.5)
    js0, ts0 = _x((B, H, N, N), 7, 0.1)
    jprev, tprev = _x((B, d), 8, 0.5)
    jy, jst = jrwkv.time_mix_apply(jtm, jx, cfg, state=js0, x_prev=jprev,
                                   return_state=True)
    ty, tst = rwkv6.time_mix_apply(ttm, tx, tcfg, state=ts0, x_prev=tprev,
                                   return_state=True)
    np.testing.assert_allclose(_np(ty), _np(jy), **WKV_TOL)
    np.testing.assert_allclose(_np(tst["wkv"]), _np(jst["wkv"]), **WKV_TOL)
    np.testing.assert_allclose(_np(tst["shift"]), _np(jst["shift"]), **TOL)


@pytest.mark.parametrize("T", [16, 37])
def test_wkv_chunked_matches_sequential(ssm, T):
    """The port's chunked WKV against its sequential scan and against the
    JAX chunked form, on clamped decays (as ``_time_mix_projections``
    makes them), T a multiple of the chunk and not."""
    cfg = ssm[0]
    H, N = cfg.num_heads, cfg.rwkv_head_dim
    rng = np.random.default_rng(9)
    r, k, v = (rng.normal(size=(2, T, H, N)).astype(np.float32)
               for _ in range(3))
    d = np.clip(rng.normal(size=(2, T, H, N)) - 1.0, -12.0,
                rwkv6.DECAY_CLAMP)
    w = np.exp(-np.exp(d)).astype(np.float32)
    u = rng.normal(size=(H, N)).astype(np.float32)
    s0 = (rng.normal(size=(2, H, N, N)) * 0.1).astype(np.float32)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    yc, sc = rwkv6._wkv_chunked(*t)
    ys, ss = rwkv6._wkv_scan(*t)
    np.testing.assert_allclose(_np(yc), _np(ys), **WKV_TOL)
    np.testing.assert_allclose(_np(sc), _np(ss), **WKV_TOL)
    jy, js = jrwkv._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u,
                                                           s0)))
    np.testing.assert_allclose(_np(yc), _np(jy), **WKV_TOL)
    np.testing.assert_allclose(_np(sc), _np(js), **WKV_TOL)


def test_time_mix_step_channel_mix_and_group_norm_match(ssm):
    cfg, tcfg, (jtm, jcm), (ttm, tcm) = ssm
    B, d = 3, cfg.d_model
    H, N = cfg.num_heads, cfg.rwkv_head_dim
    jx, tx = _x((B, d), 10, 0.5)
    js, ts = _x((B, H, N, N), 11, 0.1)
    jsh, tsh = _x((B, d), 12, 0.5)
    jy, jst = jrwkv.time_mix_step(jtm, jx, {"wkv": js, "shift": jsh}, cfg)
    ty, tst = rwkv6.time_mix_step(ttm, tx, {"wkv": ts, "shift": tsh}, tcfg)
    np.testing.assert_allclose(_np(ty), _np(jy), **WKV_TOL)
    np.testing.assert_allclose(_np(tst["wkv"]), _np(jst["wkv"]), **WKV_TOL)
    jxs, txs = _x((B, 7, d), 13)
    jo, jlast = jrwkv.channel_mix_apply(jcm, jxs, x_prev=jsh,
                                        return_state=True)
    to, tlast = rwkv6.channel_mix_apply(tcm, txs, x_prev=tsh,
                                        return_state=True)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **TOL)
    jo, jsh2 = jrwkv.channel_mix_step(jcm, jx, jsh)
    to, tsh2 = rwkv6.channel_mix_step(tcm, tx, tsh)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(_np(tsh2), _np(jsh2), **TOL)
    # group norm divides the variance by N (jnp.var)
    jg, tg = _x((B, H, N), 14, 2.0)
    jsc, tsc = _x((H * N,), 15, 0.1)
    np.testing.assert_allclose(_np(rwkv6._group_norm(tg, tsc, H, N)),
                               _np(jrwkv._group_norm(jg, jsc, H, N)), **TOL)
    init = rwkv6.rwkv_state_init(tcfg, 2, "cpu")
    jinit = jrwkv.rwkv_state_init(cfg, 2)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in jinit.items()}


def test_rwkv_time_mix_step_matches_scan(ssm):
    """Within the port: decode steps from the zero state give the prefill
    scan's outputs and its final WKV state."""
    _, tcfg, _, (ttm, _) = ssm
    B, S = 2, 8
    H, N = tcfg.num_heads, tcfg.rwkv_head_dim
    _, tx = _x((B, S, tcfg.d_model), 16, 0.5)
    y_scan, state = rwkv6.time_mix_apply(ttm, tx, tcfg, return_state=True)
    st = {"wkv": torch.zeros(B, H, N, N), "shift": torch.zeros(B,
                                                               tcfg.d_model)}
    ys = []
    for t in range(S):
        y_t, st = rwkv6.time_mix_step(ttm, tx[:, t], st, tcfg)
        ys.append(y_t)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y_scan),
                               **STEP_TOL)
    np.testing.assert_allclose(_np(st["wkv"]), _np(state["wkv"]),
                               **STEP_TOL)


def test_rwkv_channel_mix_step_matches_scan(ssm):
    _, tcfg, _, (_, tcm) = ssm
    B, S = 2, 6
    _, tx = _x((B, S, tcfg.d_model), 17)
    y_scan, last = rwkv6.channel_mix_apply(tcm, tx, return_state=True)
    shift = torch.zeros(B, tcfg.d_model)
    ys = []
    for t in range(S):
        y_t, shift = rwkv6.channel_mix_step(tcm, tx[:, t], shift)
        ys.append(y_t)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y_scan),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(shift), _np(last), atol=1e-6, rtol=1e-6)


def test_rwkv_decay_in_unit_interval(ssm):
    """Data-dependent decay w_t = exp(-exp(d)) lies in (0, 1)."""
    _, tcfg, _, (ttm, _) = ssm
    _, tx = _x((1, 16, tcfg.d_model), 18, 3.0)
    *_, w = rwkv6._time_mix_projections(ttm, tx, rwkv6._shift(tx), tcfg)
    assert w.min().item() > 0.0 and w.max().item() < 1.0
