"""Shared layer primitives: norms, RoPE, SwiGLU MLP, projections, init.

Counterpart of ``repro/models/layers.py``, with its conventions:

- attention projections keep explicit head dims: ``wq [d, H, hd]``,
  ``wk/wv [d, KV, hd]``, ``wo [H, hd, d]``;
- the residual stream is ``[B, S, d]``;
- products accumulate in f32 and cast back to the activation type;
- norms scale by ``(1 + scale)`` (zero-centred scales);
- RoPE rotates split halves, not interleaved pairs.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

F32 = torch.float32


# ---------------------------------------------------------------------------
# init helpers (truncated normal at +-3 std, as the JAX package draws them;
# the values differ, the distribution is the same)
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std, dtype, device, gen):
    t = torch.empty(shape, dtype=F32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                generator=gen)
    return t.to(dtype)


def dense_init(shape, fan_in, dtype, device, gen):
    return _trunc_normal(shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype,
                         device, gen)


def embed_init(shape, dtype, device, gen):
    return _trunc_normal(shape, 0.02, dtype, device, gen)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm over the last axis, scaled by ``(1 + scale)``; also the
    per-head qk-norm (x [..., H, hd], scale [hd])."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=device)
                            / half))


def apply_rope(x, positions, theta: float):
    """x [B, S, H, hd], positions [B, S] (int) -> same shape."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # [half]
    angles = positions[..., None].to(F32) * freqs               # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]                      # [B, S, 1, half]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_init(d_model, d_ff, dtype, device, gen, lead=()
             ) -> Dict[str, torch.Tensor]:
    """``lead`` prefixes every shape (``(L,)`` draws a layer stack at once,
    where the JAX package vmaps the per-layer init)."""
    lead = tuple(lead)
    return {
        "w_gate": dense_init(lead + (d_model, d_ff), d_model, dtype, device,
                             gen),
        "w_up": dense_init(lead + (d_model, d_ff), d_model, dtype, device,
                           gen),
        "w_down": dense_init(lead + (d_ff, d_model), d_ff, dtype, device,
                             gen),
    }


def _matmul_f32(x, w):
    """x [..., k] @ w [k, n] accumulated in f32 (f32 inputs stay exact
    f32; narrower ones are widened first)."""
    if x.dtype == F32 and w.dtype == F32:
        return x @ w
    return x.float() @ w.float()


def mlp_apply(params, x):
    gate = _matmul_f32(x, params["w_gate"])
    up = _matmul_f32(x, params["w_up"])
    h = (torch.nn.functional.silu(gate) * up).to(x.dtype)
    return _matmul_f32(h, params["w_down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------

def attn_init(cfg, dtype, device, gen, lead=()) -> Dict[str, torch.Tensor]:
    """Projection params; ``lead`` prefixes every shape (see mlp_init)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    p = {
        "wq": dense_init(lead + (d, H, hd), d, dtype, device, gen),
        "wk": dense_init(lead + (d, KV, hd), d, dtype, device, gen),
        "wv": dense_init(lead + (d, KV, hd), d, dtype, device, gen),
        "wo": dense_init(lead + (H, hd, d), H * hd, dtype, device, gen),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(lead + (hd,), dtype=F32, device=device)
        p["k_norm"] = torch.zeros(lead + (hd,), dtype=F32, device=device)
    return p


def project_qkv(params, x, *, qk_norm: bool = False, norm_eps: float = 1e-6):
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,KV,hd]."""
    B, S, d = x.shape

    def proj(w):
        _, n, e = w.shape
        return _matmul_f32(x, w.reshape(d, n * e)).reshape(B, S, n, e) \
            .to(x.dtype)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if qk_norm:
        # per-head qk-norm: the last axis is hd
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    return q, k, v


def project_out(params, attn_out):
    """attn_out [B,S,H,hd] -> [B,S,d]."""
    B, S, H, hd = attn_out.shape
    wo = params["wo"]
    out = _matmul_f32(attn_out.reshape(B, S, H * hd), wo.reshape(H * hd, -1))
    return out.to(attn_out.dtype)
