"""Decoder-only transformer, dense branch (counterpart of
``repro/models/transformer.py``).

Parameters keep the JAX package's stacked layout — a dict whose layer
leaves are ``[L, ...]`` — so weights cross over leaf for leaf
(``models/convert.py``). JAX's ``lax.scan`` over the stack becomes a
Python loop over layers.

- ``forward``      tokens [B, S] -> logits [B, S, V_padded] (f32)
- ``prefill``      tokens [B, S] -> (last-token logits, cache)
- ``decode_step``  one token per sequence against the cache

Caches are ``{"lengths" [B] int32, "k"/"v" [L, B, S, KV, hd]}``: linear,
or a ring buffer when the cache is exactly ``sliding_window`` long; or
paged, ``{"lengths", "k_pool"/"v_pool" [L, N + 1, P, KV, hd],
"block_table" [B, S / P]}``: a pool of N pages of P tokens shared by the
slots through their block-table rows, plus one trash page (index N) that
takes the writes the JAX package drops. ``decode_step`` updates the cache
IN PLACE (where JAX donates it) and returns the same dict.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    blockwise_attention, cache_write, decode_attention,
    paged_cache_write, paged_decode_attention, ring_positions,
)
from repro_torch.models.layers import (
    apply_rope, attn_init, dense_init, embed_init, mlp_apply, mlp_init,
    project_out, project_qkv, rms_norm,
)

F32 = torch.float32
ATTN_CHUNK = 512  # query-chunk size of the eager attention path


def _check_dense(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"the PyTorch port serves the dense family only so far "
            f"({cfg.name!r} is {cfg.family!r})")


# ===========================================================================
# init
# ===========================================================================

def init_params(cfg: ModelConfig, dtype=F32, *, device="cuda",
                generator: Optional[torch.Generator] = None):
    """Random parameters on ``device`` from ``generator`` (seeded by the
    caller), each stacked ``[L, ...]`` leaf drawn whole."""
    _check_dense(cfg)
    device = resolve_device(device)
    gen = generator
    V, d, L = cfg.padded_vocab_size, cfg.d_model, cfg.num_layers
    params: Dict[str, Any] = {
        "embed": embed_init((V, d), dtype, device, gen),
        "final_norm": torch.zeros((d,), dtype=F32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, V), d, dtype, device, gen)
    params["layers"] = {
        "ln1": torch.zeros((L, d), dtype=F32, device=device),
        "ln2": torch.zeros((L, d), dtype=F32, device=device),
        "attn": attn_init(cfg, dtype, device, gen, lead=(L,)),
        "mlp": mlp_init(d, cfg.d_ff, dtype, device, gen, lead=(L,)),
    }
    return params


def layer_params(params, i: int):
    """The ``i``-th layer's slice of the stacked layer leaves (views)."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]
    return take(params["layers"])


# ===========================================================================
# shared pieces
# ===========================================================================

def _embed_tokens(params, cfg, tokens):
    x = params["embed"][tokens]
    scale = math.sqrt(cfg.d_model) if cfg.tie_embeddings else 1.0
    return x * torch.tensor(scale, dtype=x.dtype)


def _lm_logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ w.float()          # f32 [.., V_padded]


def _attn_block_seq(lp, x, cfg, positions, window):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(lp["attn"], h, qk_norm=cfg.qk_norm,
                          norm_eps=cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=True, window=window,
                            chunk=ATTN_CHUNK, logit_cap=cfg.attn_logit_softcap)
    return x + project_out(lp["attn"], o), k, v


def _mlp_block(lp, x, cfg):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h)


# ===========================================================================
# forward (scoring)
# ===========================================================================

def forward(params, batch, cfg: ModelConfig):
    """batch: {"tokens": [B, S]} -> logits [B, S, V_padded] f32."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        x, _, _ = _attn_block_seq(lp, x, cfg, positions, cfg.sliding_window)
        x = _mlp_block(lp, x, cfg)
    return _lm_logits(params, cfg, x)


# ===========================================================================
# caches
# ===========================================================================

def attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, *, device="cuda",
               paged: Optional[Tuple[int, int]] = None):
    """Decode cache sized for ``seq_len`` context (linear layout; a
    sliding window shorter than ``seq_len`` makes it a ring of the
    window's length).

    ``paged=(num_blocks, page_size)`` selects the paged layout: a pool of
    ``num_blocks`` pages (plus the trash page) addressed through a
    ``block_table`` whose entries start at the sentinel ``num_blocks``.
    Only a linear cache pages (``transformer.py:317-345`` of the JAX
    package)."""
    _check_dense(cfg)
    device = resolve_device(device)
    if paged is not None:
        if cfg.sliding_window is not None and cfg.sliding_window < seq_len:
            raise ValueError(
                "paged KV cache requires a linear attention cache "
                f"(sliding_window {cfg.sliding_window} < {seq_len})")
        num_blocks, page = paged
        if seq_len % page:
            raise ValueError(f"page_size {page} must divide seq_len {seq_len}")
        shape = (cfg.num_layers, num_blocks + 1, page, cfg.num_kv_heads,
                 cfg.head_dim)
        return {
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k_pool": torch.zeros(shape, dtype=dtype, device=device),
            "v_pool": torch.zeros(shape, dtype=dtype, device=device),
            "block_table": torch.full((batch, seq_len // page), num_blocks,
                                      dtype=torch.int32, device=device),
        }
    S = attn_cache_len(cfg, seq_len)
    shape = (cfg.num_layers, batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# ===========================================================================
# prefill
# ===========================================================================

def _ring_pack(full, W):
    """Pack the last W entries of full [B, S, ...] into ring-slot order."""
    S = full.shape[1]
    if S <= W:
        out = full.new_zeros((full.shape[0], W) + tuple(full.shape[2:]))
        out[:, :S] = full
        return out
    slots = torch.arange(S - W, S, device=full.device) % W
    out = full.new_zeros((full.shape[0], W) + tuple(full.shape[2:]))
    out[:, slots] = full[:, S - W:]
    return out


def prefill(params, batch, cfg: ModelConfig, *,
            cache_len: Optional[int] = None, cache_dtype=torch.bfloat16):
    """Run the full prompt; return (last-token logits [B, V], cache).

    ``batch["prompt_lengths"]`` [B] holds each right-padded prompt's true
    length (causal masking keeps pads out of real tokens' attention, and
    decode masks by length)."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    cache_len = cache_len or S
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=dev).expand(B, S)
    cache = init_cache(cfg, B, cache_len, cache_dtype, device=dev)
    lengths = batch.get("prompt_lengths")
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev) \
        if lengths is None else lengths.to(device=dev, dtype=torch.int32)
    W = cache["k"].shape[2]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        x, k, v = _attn_block_seq(lp, x, cfg, positions, cfg.sliding_window)
        cache["k"][i] = _ring_pack(k, W).to(cache_dtype)
        cache["v"][i] = _ring_pack(v, W).to(cache_dtype)
        x = _mlp_block(lp, x, cfg)
    cache["lengths"] = lengths
    last = torch.gather(
        x, 1, (lengths.long() - 1)[:, None, None].expand(B, 1, x.shape[-1]))
    return _lm_logits(params, cfg, last[:, 0]), cache


# ===========================================================================
# decode step
# ===========================================================================

def _attn_decode(lp, x_t, k_cache, v_cache, lengths, cfg, *, ring_window):
    """x_t [B, d]; k/v_cache [B, W, KV, hd] (updated in place)."""
    h = rms_norm(x_t[:, None], lp["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(lp["attn"], h, qk_norm=cfg.qk_norm,
                          norm_eps=cfg.norm_eps)
    pos = lengths[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    ring = ring_window is not None
    cache_write(k_cache, v_cache, k[:, 0], v[:, 0], lengths, ring=ring)
    if ring:
        kv_pos = ring_positions(lengths + 1, k_cache.shape[1])
        o = decode_attention(q[:, 0], k_cache, v_cache, lengths=lengths + 1,
                             kv_positions=kv_pos,
                             logit_cap=cfg.attn_logit_softcap)
    else:
        o = decode_attention(q[:, 0], k_cache, v_cache, lengths=lengths + 1,
                             logit_cap=cfg.attn_logit_softcap)
    return x_t + project_out(lp["attn"], o[:, None])[:, 0]


def _paged_attn_decode(lp, x_t, k_pool, v_pool, block_table, lengths, cfg):
    """x_t [B, d]; k/v_pool [N + 1, P, KV, hd] (this layer's pages and the
    trash page, updated in place); block_table [B, nb]."""
    h = rms_norm(x_t[:, None], lp["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(lp["attn"], h, qk_norm=cfg.qk_norm,
                          norm_eps=cfg.norm_eps)
    pos = lengths[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    paged_cache_write(k_pool, v_pool, k[:, 0], v[:, 0], block_table, lengths)
    N = k_pool.shape[0] - 1
    o = paged_decode_attention(q[:, 0], k_pool[:N], v_pool[:N], block_table,
                               lengths + 1, logit_cap=cfg.attn_logit_softcap)
    return x_t + project_out(lp["attn"], o[:, None])[:, 0]


def _mlp_decode(lp, x_t, cfg):
    h = rms_norm(x_t[:, None], lp["ln2"], cfg.norm_eps)
    return x_t + mlp_apply(lp["mlp"], h)[:, 0]


def decode_step(params, cache, tokens, cfg: ModelConfig, *, active=None):
    """tokens [B] -> (logits [B, V_padded] f32, cache).

    ``active`` (optional [B] bool) is the per-slot termination state of the
    fused decode: inactive slots do not advance ``cache["lengths"]`` (their
    writes land past their valid length and stay invisible). The cache is
    updated in place and returned."""
    _check_dense(cfg)
    lengths = cache["lengths"]
    x = _embed_tokens(params, cfg, tokens[:, None])[:, 0]
    adv = 1 if active is None else active.to(torch.int32)
    if "k_pool" in cache:
        # paged layout; the block table and lengths hold for the whole step
        table = cache["block_table"]
        for i in range(cfg.num_layers):
            lp = layer_params(params, i)
            x = _paged_attn_decode(lp, x, cache["k_pool"][i],
                                   cache["v_pool"][i], table, lengths, cfg)
            x = _mlp_decode(lp, x, cfg)
        cache["lengths"] = lengths + adv
        return _lm_logits(params, cfg, x), cache
    S = cache["k"].shape[2]
    ring_window = cfg.sliding_window if (
        cfg.sliding_window is not None and S == cfg.sliding_window) else None
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        x = _attn_decode(lp, x, cache["k"][i], cache["v"][i], lengths, cfg,
                         ring_window=ring_window)
        x = _mlp_decode(lp, x, cfg)
    cache["lengths"] = lengths + adv
    return _lm_logits(params, cfg, x), cache
