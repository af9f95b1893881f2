"""RWKV-6 "Finch" layer (arXiv:2404.05892): attention-free, data-dependent
decay (counterpart of ``repro/models/rwkv6.py``).

Time-mix (per head, head dim N):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T              state S in R^{N x N}
    y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
with per-channel data-dependent decay w_t = exp(-exp(d_t)) produced by a
low-rank (LoRA) projection of the token-shift mix, and bonus u.

Token shift uses Finch's DDLERP: a data-dependent lerp between x_t and
x_{t-1} with per-projection LoRA adjustments. Channel-mix is the RWKV
squared-ReLU gated MLP with plain lerp token shift.

Prefill dispatches the WKV as the JAX package does (``rwkv6.py:222-230``),
with the tensors' device in place of its backend switch: CUDA tensors run
the ``wkv_scan`` kernel (``kernels/ops.py``); on the CPU a sequence longer
than one token takes the chunked-parallel form when the ``chunked_wkv``
flag is set (``flags.py``), else the sequential scan. Decode is an O(1)
state update in plain PyTorch.

Parameter leaves keep the JAX package's shapes, with an optional leading
stack (``lead``) as ``transformer.init_params`` draws whole layer stacks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import flags
from repro_torch.kernels import ops as _kops
from repro_torch.models.layers import _matmul_f32, dense_init

F32 = torch.float32
LORA_MIX = 32     # DDLERP lora rank
LORA_DECAY = 64   # decay lora rank

_MIX_NAMES = ("r", "k", "v", "g", "w")


def rwkv_time_mix_init(cfg, dtype, device, gen, lead=()):
    d = cfg.d_model
    H, N = cfg.num_heads, cfg.rwkv_head_dim
    assert H * N == d
    lead = tuple(lead)

    def const(t):
        return t.expand(lead + tuple(t.shape)).clone()

    p = {
        "mu_x": torch.zeros(lead + (d,), dtype=F32, device=device),
        "w_r": dense_init(lead + (d, d), d, dtype, device, gen),
        "w_k": dense_init(lead + (d, d), d, dtype, device, gen),
        "w_v": dense_init(lead + (d, d), d, dtype, device, gen),
        "w_g": dense_init(lead + (d, d), d, dtype, device, gen),
        "w_o": dense_init(lead + (d, d), d, dtype, device, gen),
        # decay lora: d -> LORA_DECAY -> d, plus base decay
        "decay_base": const(torch.linspace(-6.0, -0.5, d, dtype=F32,
                                           device=device)),
        "decay_a": dense_init(lead + (d, LORA_DECAY), d, F32, device, gen),
        "decay_b": dense_init(lead + (LORA_DECAY, d), LORA_DECAY, F32,
                              device, gen),
        "bonus_u": const(torch.arange(d, dtype=F32, device=device) / d
                         - 0.5),
        "ln_out": torch.zeros(lead + (d,), dtype=F32, device=device),
    }
    for nm in _MIX_NAMES:
        p[f"mix_mu_{nm}"] = torch.zeros(lead + (d,), dtype=F32, device=device)
        p[f"mix_a_{nm}"] = dense_init(lead + (d, LORA_MIX), d, F32, device,
                                      gen)
        p[f"mix_b_{nm}"] = dense_init(lead + (LORA_MIX, d), LORA_MIX, F32,
                                      device, gen)
    return p


def rwkv_channel_mix_init(cfg, dtype, device, gen, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "mu_k": torch.zeros(lead + (d,), dtype=F32, device=device),
        "mu_r": torch.zeros(lead + (d,), dtype=F32, device=device),
        "w_k": dense_init(lead + (d, f), d, dtype, device, gen),
        "w_v": dense_init(lead + (f, d), f, dtype, device, gen),
        "w_r": dense_init(lead + (d, d), d, dtype, device, gen),
    }


# ---------------------------------------------------------------------------
# token shift + DDLERP
# ---------------------------------------------------------------------------

def _shift(x, x_prev_last=None):
    """x [B, S, d] -> x_{t-1} along S. First step uses x_prev_last [B, d]."""
    first = torch.zeros_like(x[:, :1]) if x_prev_last is None \
        else x_prev_last[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p, nm, x, xp):
    """Finch data-dependent lerp for projection ``nm``. x, xp [..., d] f32."""
    base = x + (xp - x) * p["mu_x"]
    lora = p[f"mix_mu_{nm}"] + torch.tanh(base @ p[f"mix_a_{nm}"]) \
        @ p[f"mix_b_{nm}"]
    return x + (xp - x) * lora


# ---------------------------------------------------------------------------
# WKV recurrence
# ---------------------------------------------------------------------------

WKV_CHUNK = 16
# Decay exponent clamp: w = exp(-exp(d)) with d <= DECAY_CLAMP bounds
# e^{-lw} within a chunk to exp(WKV_CHUNK * e^{DECAY_CLAMP}) ~ e^72 < f32
# max. Decays faster than exp(-4.5) per step are saturated — indistinguish-
# able from zero after 2 tokens, so semantics are preserved in practice.
DECAY_CLAMP = 1.5


def _wkv_chunked(r, k, v, w, u, state, *, chunk=WKV_CHUNK):
    """Chunked-parallel WKV (flash-linear-attention style), as in the JAX
    package (``rwkv6.py:100-162``): the state carries per chunk, and
    within a chunk the interactions are masked matmuls with relative decay
    products ``exp(logW[t-1] - logW[i])`` (every exponent <= 0).

    r/k/v/w [B, T, H, N] f32; u [H, N]; state [B, H, N, N]. Returns
    (y [B, T, H, N], final_state), equal up to f32 reassociation to the
    sequential scan."""
    B, T, H, N = r.shape
    pad = (-T) % chunk
    if pad:
        def zeros(t):
            return F.pad(t, (0, 0, 0, 0, 0, pad))
        r, k, v = zeros(r), zeros(k), zeros(v)
        # identity decay on pads
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    Tp = T + pad
    nc = Tp // chunk

    def resh(t):                      # -> [nc, B, H, c, N]
        return t.reshape(B, nc, chunk, H, N).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    mask = torch.arange(chunk, device=r.device)[:, None] \
        > torch.arange(chunk, device=r.device)[None, :]
    S = state
    ys = []
    for c in range(nc):
        rc_, kc_, vc_, wc_ = rc[c], kc[c], vc[c], wc[c]   # [B, H, c, N]
        logw = torch.log(wc_)
        lw = torch.cumsum(logw, dim=2)          # logW_t (inclusive), <= 0
        lw_prev = lw - logw                     # logW_{t-1} (exclusive)
        # inter-chunk: r_t . (W_{t-1} o S)
        r_dec = rc_ * torch.exp(lw_prev)
        y_inter = torch.einsum("bhti,bhij->bhtj", r_dec, S)
        # intra-chunk, factorised (bounded by DECAY_CLAMP)
        k_inv = kc_ * torch.exp(-lw)
        scores = torch.einsum("bhtn,bhin->bhti", r_dec, k_inv)
        scores = torch.where(mask, scores, 0.0)
        y_intra = torch.einsum("bhti,bhin->bhtn", scores, vc_)
        # diagonal (bonus) term
        diag = torch.sum(rc_ * u[None, :, None, :] * kc_, dim=-1)  # [B,H,c]
        y_diag = diag[..., None] * vc_
        ys.append(y_inter + y_intra + y_diag)
        # state update: S' = W_end o S + sum_i e^{lw_end - lw_i} k_i v_i^T
        lw_end = lw[:, :, -1:, :]
        k_dec = kc_ * torch.exp(lw_end - lw)
        S = torch.exp(lw_end[:, :, 0, :])[..., :, None] * S + torch.einsum(
            "bhtn,bhtm->bhnm", k_dec, vc_)
    # ys [nc] x [B, H, c, N] -> [B, T, H, N]
    y = torch.stack(ys, dim=0).permute(1, 0, 3, 2, 4).reshape(B, Tp, H, N)
    return y[:, :T], S


def _wkv_scan(r, k, v, w, u, state):
    """Sequential WKV. r/k/v/w [B, S, H, N] f32; u [H, N]; state
    [B, H, N, N]. Returns (y [B, S, H, N], final_state). State layout:
    S[i, j] accumulates k_i * v_j."""
    uu = u[None, :, :, None]
    s = state
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, N, N]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _group_norm(y, scale, H, N, eps=1e-5):
    """Per-head layer norm over N. y [..., H, N] f32, scale [H*N]."""
    mean = y.mean(dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)  # jnp.var: / N
    yn = (y - mean) * torch.rsqrt(var + eps)
    return yn.reshape(tuple(y.shape[:-2]) + (H * N,)) * (1.0 + scale)


def _time_mix_projections(p, x, xp, cfg):
    """Shared by scan & step. x, xp [..., d] -> r, k, v, g, w (heads
    split, except g)."""
    H, N = cfg.num_heads, cfg.rwkv_head_dim
    x32, xp32 = x.float(), xp.float()
    xr = _ddlerp(p, "r", x32, xp32)
    xk = _ddlerp(p, "k", x32, xp32)
    xv = _ddlerp(p, "v", x32, xp32)
    xg = _ddlerp(p, "g", x32, xp32)
    xw = _ddlerp(p, "w", x32, xp32)

    r = _matmul_f32(xr.to(x.dtype), p["w_r"]).float()
    k = _matmul_f32(xk.to(x.dtype), p["w_k"]).float()
    v = _matmul_f32(xv.to(x.dtype), p["w_v"]).float()
    g = F.silu(_matmul_f32(xg.to(x.dtype), p["w_g"]).float())

    d_t = p["decay_base"] + torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
    d_t = torch.clamp(d_t, -12.0, DECAY_CLAMP)   # see DECAY_CLAMP note
    w = torch.exp(-torch.exp(d_t))                             # in (0, 1)

    def split(t):
        return t.reshape(tuple(t.shape[:-1]) + (H, N))
    return split(r), split(k), split(v), g, split(w)


def time_mix_apply(p, x, cfg, *, state=None, x_prev=None,
                   return_state=False):
    """Prefill/scoring time-mix. x [B, S, d]."""
    B, S, d = x.shape
    H, N = cfg.num_heads, cfg.rwkv_head_dim
    xp = _shift(x, x_prev)
    r, k, v, g, w = _time_mix_projections(p, x, xp, cfg)
    if state is None:
        state = torch.zeros((B, H, N, N), dtype=F32, device=x.device)
    u = p["bonus_u"].reshape(H, N)
    if x.device.type == "cuda":
        y, final = _kops.wkv_scan(r, k, v, w, u, state)
    elif S > 1 and flags.enabled("chunked_wkv"):
        y, final = _wkv_chunked(r, k, v, w, u, state)
    else:
        y, final = _wkv_scan(r, k, v, w, u, state)
    y = _group_norm(y, p["ln_out"], H, N) * g
    out = _matmul_f32(y.to(x.dtype), p["w_o"]).to(x.dtype)
    if return_state:
        return out, {"wkv": final, "shift": x[:, -1].float()}
    return out


def time_mix_step(p, x_t, st, cfg):
    """Decode time-mix. x_t [B, d]; st {'wkv': [B,H,N,N], 'shift': [B,d]}."""
    H, N = cfg.num_heads, cfg.rwkv_head_dim
    xp = st["shift"].to(x_t.dtype)
    r, k, v, g, w = _time_mix_projections(p, x_t, xp, cfg)
    u = p["bonus_u"].reshape(H, N)
    s = st["wkv"]
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", r, s + u[None, :, :, None] * kv)
    s = w[..., :, None] * s + kv
    y = _group_norm(y, p["ln_out"], H, N) * g
    out = _matmul_f32(y.to(x_t.dtype), p["w_o"]).to(x_t.dtype)
    return out, {"wkv": s, "shift": x_t.float()}


# ---------------------------------------------------------------------------
# channel mix
# ---------------------------------------------------------------------------

def channel_mix_apply(p, x, *, x_prev=None, return_state=False):
    xp = _shift(x, x_prev)
    x32, xp32 = x.float(), xp.float()
    xk = (x32 + (xp32 - x32) * p["mu_k"]).to(x.dtype)
    xr = (x32 + (xp32 - x32) * p["mu_r"]).to(x.dtype)
    kk = torch.square(torch.relu(_matmul_f32(xk, p["w_k"]).float())
                      ).to(x.dtype)
    rr = torch.sigmoid(_matmul_f32(xr, p["w_r"]).float()).to(x.dtype)
    out = rr * _matmul_f32(kk, p["w_v"]).to(x.dtype)
    if return_state:
        return out, x[:, -1].float()
    return out


def channel_mix_step(p, x_t, shift_state):
    xp = shift_state.to(x_t.dtype)
    x32, xp32 = x_t.float(), xp.float()
    xk = (x32 + (xp32 - x32) * p["mu_k"]).to(x_t.dtype)
    xr = (x32 + (xp32 - x32) * p["mu_r"]).to(x_t.dtype)
    kk = torch.square(torch.relu(_matmul_f32(xk, p["w_k"]).float())
                      ).to(x_t.dtype)
    rr = torch.sigmoid(_matmul_f32(xr, p["w_r"]).float()).to(x_t.dtype)
    out = rr * _matmul_f32(kk, p["w_v"]).to(x_t.dtype)
    return out, x_t.float()


def rwkv_state_init(cfg, batch, device):
    H, N, d = cfg.num_heads, cfg.rwkv_head_dim, cfg.d_model
    return {
        "wkv": torch.zeros((batch, H, N, N), dtype=F32, device=device),
        "tm_shift": torch.zeros((batch, d), dtype=F32, device=device),
        "cm_shift": torch.zeros((batch, d), dtype=F32, device=device),
    }
