"""Decoder-only transformer: the dense, MoE, hybrid (RecurrentGemma) and
SSM (RWKV-6) families (counterpart of ``repro/models/transformer.py``).

Parameters keep the JAX package's stacked layout, so weights cross over
leaf for leaf (``models/convert.py``): dense, MoE and SSM layers under
``layers`` with ``[L, ...]`` leaves (an MoE layer's feed-forward is
``layers/moe/w_router|w_gate|w_up|w_down``, ``models/moe.py``); the
hybrid's (rec, rec, attn) pattern blocks under ``blocks/l{i}`` with
``[num_blocks, ...]`` leaves, plus its recurrent ``tail``
``[num_tail, ...]``. JAX's ``lax.scan`` over a
stack becomes a Python loop.

- ``forward``      tokens [B, S] -> logits [B, S, V_padded] (f32)
- ``prefill``      tokens [B, S] -> (last-token logits, cache)
- ``decode_step``  one token per sequence against the cache

Dense and MoE caches are ``{"lengths" [B] int32, "k"/"v" [L, B, S, KV,
hd]}``: linear, or a ring buffer when the cache is exactly ``sliding_window``
long; or paged, ``{"lengths", "k_pool"/"v_pool" [L, N + 1, P, KV, hd],
"block_table" [B, S / P]}``: a pool of N pages of P tokens shared by the
slots through their block-table rows, plus one trash page (index N) that
takes the writes the JAX package drops. The recurrent families keep the
JAX package's leaves (``CACHE_BATCH_AXIS`` names each one's batch axis):
the hybrid ``attn_k``/``attn_v`` [nb, B, W, KV, hd] (a ring of the local
window W), ``rec_h`` [nb, n_rec, B, lru], ``rec_conv`` [nb, n_rec, B, 3,
lru] and ``tail_h``/``tail_conv`` [n_tail, B, ...]; the SSM ``wkv`` [L, B,
H, N, N] and ``tm_shift``/``cm_shift`` [L, B, d]. ``decode_step`` updates
the cache IN PLACE (where JAX donates it) and returns the same dict.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import moe, rglru, rwkv6
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


FAMILIES = ("dense", "moe", "hybrid", "ssm")
# the batch axis of each cache leaf (the JAX engine finds it by shape,
# ``engine.py:220-234``; a stack dimension of 1 would look the same)
CACHE_BATCH_AXIS = {"lengths": 0, "k": 1, "v": 1, "attn_k": 1, "attn_v": 1,
                    "rec_h": 2, "rec_conv": 2, "tail_h": 1, "tail_conv": 1,
                    "wkv": 1, "tm_shift": 1, "cm_shift": 1}


def _check_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the PyTorch port serves the {', '.join(FAMILIES)} families so "
            f"far ({cfg.name!r} is {cfg.family!r})")


# ===========================================================================
# init
# ===========================================================================

def _layer_init(cfg: ModelConfig, dtype, device, gen, kind: str, n: int):
    """A stack of ``n`` layers of ``kind``, each leaf ``[n, ...]``."""
    d, lead = cfg.d_model, (n,)
    p: Dict[str, Any] = {
        "ln1": torch.zeros((n, d), dtype=F32, device=device),
        "ln2": torch.zeros((n, d), dtype=F32, device=device),
    }
    if kind == "attn":
        p["attn"] = attn_init(cfg, dtype, device, gen, lead=lead)
        p["mlp"] = mlp_init(d, cfg.d_ff, dtype, device, gen, lead=lead)
    elif kind == "moe":
        p["attn"] = attn_init(cfg, dtype, device, gen, lead=lead)
        p["moe"] = moe.moe_init(cfg, dtype, device, gen, lead=lead)
    elif kind == "rec":
        p["rec"] = rglru.rglru_init(cfg, dtype, device, gen, lead=lead)
        p["mlp"] = mlp_init(d, cfg.d_ff, dtype, device, gen, lead=lead)
    elif kind == "rwkv":
        p["tm"] = rwkv6.rwkv_time_mix_init(cfg, dtype, device, gen,
                                           lead=lead)
        p["cm"] = rwkv6.rwkv_channel_mix_init(cfg, dtype, device, gen,
                                              lead=lead)
    else:
        raise ValueError(kind)
    return p


def init_params(cfg: ModelConfig, dtype=F32, *, device="cuda",
                generator: Optional[torch.Generator] = None):
    """Random parameters on ``device`` from ``generator`` (seeded by the
    caller), each stacked leaf drawn whole."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = generator
    V, d = cfg.padded_vocab_size, cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init((V, d), dtype, device, gen),
        "final_norm": torch.zeros((d,), dtype=F32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, V), d, dtype, device, gen)
    if cfg.family == "hybrid":
        nb = cfg.num_pattern_blocks
        params["blocks"] = {
            f"l{i}": _layer_init(cfg, dtype, device, gen,
                                 "attn" if kind == "attn" else "rec", nb)
            for i, kind in enumerate(cfg.block_pattern)}
        if cfg.num_tail_layers:
            params["tail"] = _layer_init(cfg, dtype, device, gen, "rec",
                                         cfg.num_tail_layers)
    elif cfg.family == "ssm":
        params["layers"] = _layer_init(cfg, dtype, device, gen, "rwkv",
                                       cfg.num_layers)
    else:
        params["layers"] = _layer_init(cfg, dtype, device, gen,
                                       "moe" if cfg.is_moe else "attn",
                                       cfg.num_layers)
    return params


def take(tree, i: int):
    """The ``i``-th entry of every stacked leaf of ``tree`` (views)."""
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(params, i: int):
    """The ``i``-th layer's slice of the stacked layer leaves (views)."""
    return take(params["layers"], i)


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


def _ffn_block(lp, x, cfg):
    """x [B, S, d] -> (x + the layer's feed-forward of x, its MoEAux or
    None): the MLP, or the MoE layer over the B x S tokens of the call."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe.moe_apply(lp["moe"], h, cfg)
        return x + y, aux
    return x + mlp_apply(lp["mlp"], h), None


def _rec_block_seq(lp, x, cfg, *, return_state=False):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    out = rglru.recurrent_block_apply(lp["rec"], h,
                                      return_state=return_state)
    if return_state:
        y, state = out
        return x + y, state
    return x + out


def _rwkv_layer_seq(lp, x, cfg, *, return_state=False):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if return_state:
        y, tm_state = rwkv6.time_mix_apply(lp["tm"], h, cfg,
                                           return_state=True)
    else:
        y = rwkv6.time_mix_apply(lp["tm"], h, cfg)
    x = x + y
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if return_state:
        y2, cm_shift = rwkv6.channel_mix_apply(lp["cm"], h2,
                                               return_state=True)
        return x + y2, {"wkv": tm_state["wkv"],
                        "tm_shift": tm_state["shift"], "cm_shift": cm_shift}
    return x + rwkv6.channel_mix_apply(lp["cm"], h2)


def _hybrid_layers(params, cfg):
    """The hybrid's layers in order: (kind, params, block, index of the
    layer among its block's recurrent layers) for the pattern blocks, then
    ("tail", params, tail index, 0) for the recurrent tail."""
    for bi in range(cfg.num_pattern_blocks):
        ri = 0
        for i, kind in enumerate(cfg.block_pattern):
            lp = take(params["blocks"][f"l{i}"], bi)
            if kind == "attn":
                yield "attn", lp, bi, 0
            else:
                yield "rec", lp, bi, ri
                ri += 1
    for ti in range(cfg.num_tail_layers):
        yield "tail", take(params["tail"], ti), ti, 0


# ===========================================================================
# forward (scoring)
# ===========================================================================

def forward(params, batch, cfg: ModelConfig, *, return_aux=False):
    """batch: {"tokens": [B, S]} -> logits [B, S, V_padded] f32; with
    ``return_aux``, (logits, (load balance loss, router z-loss)), the
    losses averaged over the MoE layers (zeros for the other families), as
    the JAX package's ``forward``."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    lb = z = torch.zeros((), dtype=F32, device=tokens.device)
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _rwkv_layer_seq(layer_params(params, i), x, cfg)
    elif cfg.family == "hybrid":
        for kind, lp, _, _ in _hybrid_layers(params, cfg):
            if kind == "attn":
                x, _, _ = _attn_block_seq(lp, x, cfg, positions,
                                          cfg.local_attn_window)
            else:
                x = _rec_block_seq(lp, x, cfg)
            x = _ffn_block(lp, x, cfg)[0]
    else:
        for i in range(cfg.num_layers):
            lp = layer_params(params, i)
            x, _, _ = _attn_block_seq(lp, x, cfg, positions,
                                      cfg.sliding_window)
            x, aux = _ffn_block(lp, x, cfg)
            if aux is not None:
                lb, z = lb + aux.load_balance_loss, z + aux.z_loss
        lb, z = lb / cfg.num_layers, z / cfg.num_layers
    logits = _lm_logits(params, cfg, x)
    return (logits, (lb, z)) if return_aux else logits


# ===========================================================================
# caches
# ===========================================================================

def attn_cache_len(cfg: ModelConfig, seq_len: int, *,
                   local: bool = False) -> int:
    if local:
        return min(cfg.local_attn_window, seq_len)
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, *, device="cuda",
               paged: Optional[Tuple[int, int]] = None):
    """Decode cache sized for ``seq_len`` context (linear layout; a
    sliding window shorter than ``seq_len`` makes it a ring of the
    window's length; the hybrid's local attention is a ring of
    ``min(local_attn_window, seq_len)``, the SSM's state has no length).

    ``paged=(num_blocks, page_size)`` selects the paged layout: a pool of
    ``num_blocks`` pages (plus the trash page) addressed through a
    ``block_table`` whose entries start at the sentinel ``num_blocks``.
    Only a linear cache pages (``transformer.py:317-345`` of the JAX
    package)."""
    _check_family(cfg)
    device = resolve_device(device)
    if paged is not None:
        if (cfg.family in ("ssm", "hybrid")
                or (cfg.sliding_window is not None
                    and cfg.sliding_window < seq_len)):
            raise ValueError(
                "paged KV cache requires a linear attention cache "
                f"(family {cfg.family!r}, sliding_window "
                f"{cfg.sliding_window!r})")
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
    cache: Dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def zeros(*shape, dt=F32):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.family == "ssm":
        L, d = cfg.num_layers, cfg.d_model
        H, N = cfg.num_heads, cfg.rwkv_head_dim
        cache.update(wkv=zeros(L, batch, H, N, N),
                     tm_shift=zeros(L, batch, d), cm_shift=zeros(L, batch, d))
        return cache
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.family == "hybrid":
        if sum(k == "attn" for k in cfg.block_pattern) != 1:
            raise NotImplementedError("one attention layer per pattern "
                                      "block (as the JAX cache layout)")
        nb, lw = cfg.num_pattern_blocks, cfg.lru_width
        W = attn_cache_len(cfg, seq_len, local=True)
        n_rec = sum(1 for k in cfg.block_pattern if k != "attn")
        cw = rglru.CONV_WIDTH - 1
        cache.update(attn_k=zeros(nb, batch, W, KV, hd, dt=dtype),
                     attn_v=zeros(nb, batch, W, KV, hd, dt=dtype),
                     rec_h=zeros(nb, n_rec, batch, lw),
                     rec_conv=zeros(nb, n_rec, batch, cw, lw))
        if cfg.num_tail_layers:
            nt = cfg.num_tail_layers
            cache.update(tail_h=zeros(nt, batch, lw),
                         tail_conv=zeros(nt, batch, cw, lw))
        return cache
    S = attn_cache_len(cfg, seq_len)
    cache.update(k=zeros(cfg.num_layers, batch, S, KV, hd, dt=dtype),
                 v=zeros(cfg.num_layers, batch, S, KV, hd, dt=dtype))
    return cache


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
    _check_family(cfg)
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
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x, st = _rwkv_layer_seq(layer_params(params, i), x, cfg,
                                    return_state=True)
            for name, value in st.items():
                cache[name][i] = value
    elif cfg.family == "hybrid":
        W = cache["attn_k"].shape[2]
        for kind, lp, i, ri in _hybrid_layers(params, cfg):
            if kind == "attn":
                x, k, v = _attn_block_seq(lp, x, cfg, positions,
                                          cfg.local_attn_window)
                cache["attn_k"][i] = _ring_pack(k, W).to(cache_dtype)
                cache["attn_v"][i] = _ring_pack(v, W).to(cache_dtype)
            else:
                x, st = _rec_block_seq(lp, x, cfg, return_state=True)
                if kind == "rec":
                    cache["rec_h"][i, ri] = st["h"]
                    cache["rec_conv"][i, ri] = st["conv"]
                else:
                    cache["tail_h"][i] = st["h"]
                    cache["tail_conv"][i] = st["conv"]
            x = _ffn_block(lp, x, cfg)[0]
    else:
        W = cache["k"].shape[2]
        for i in range(cfg.num_layers):
            lp = layer_params(params, i)
            x, k, v = _attn_block_seq(lp, x, cfg, positions,
                                      cfg.sliding_window)
            cache["k"][i] = _ring_pack(k, W).to(cache_dtype)
            cache["v"][i] = _ring_pack(v, W).to(cache_dtype)
            x = _ffn_block(lp, x, cfg)[0]
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


def _ffn_decode(lp, x_t, cfg):
    """x_t [B, d]: ``_ffn_block`` on one token per slot (an MoE layer runs
    over the B tokens of the step, ``_moe_decode`` of the JAX package; no
    assignment drops at B <= 8)."""
    return _ffn_block(lp, x_t[:, None], cfg)[0][:, 0]


def _ssm_decode(params, cache, x, cfg):
    """The RWKV layers on one token per slot; the states update in
    place."""
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rms_norm(x[:, None], lp["ln1"], cfg.norm_eps)[:, 0]
        y, tm = rwkv6.time_mix_step(
            lp["tm"], h, {"wkv": cache["wkv"][i],
                          "shift": cache["tm_shift"][i]}, cfg)
        x = x + y
        h2 = rms_norm(x[:, None], lp["ln2"], cfg.norm_eps)[:, 0]
        y2, cm_shift = rwkv6.channel_mix_step(lp["cm"], h2,
                                              cache["cm_shift"][i])
        x = x + y2
        cache["wkv"][i] = tm["wkv"]
        cache["tm_shift"][i] = tm["shift"]
        cache["cm_shift"][i] = cm_shift
    return x


def _hybrid_decode(params, cache, x, cfg):
    """The hybrid's layers on one token per slot. The local attention is
    always a ring of the window (``transformer.py:622-624`` of the JAX
    package): the eager path with ``kv_positions``, no decode kernel,
    even when the cache is shorter than the window."""
    for kind, lp, i, ri in _hybrid_layers(params, cfg):
        if kind == "attn":
            x = _attn_decode(lp, x, cache["attn_k"][i], cache["attn_v"][i],
                             cache["lengths"], cfg,
                             ring_window=cfg.local_attn_window)
        else:
            hk, ck = ("rec_h", "rec_conv") if kind == "rec" \
                else ("tail_h", "tail_conv")
            where = (i, ri) if kind == "rec" else (i,)
            h = rms_norm(x[:, None], lp["ln1"], cfg.norm_eps)[:, 0]
            y, st = rglru.recurrent_block_step(
                lp["rec"], h, {"h": cache[hk][where],
                               "conv": cache[ck][where]})
            x = x + y
            cache[hk][where] = st["h"]
            cache[ck][where] = st["conv"]
        x = _ffn_decode(lp, x, cfg)
    return x


def decode_step(params, cache, tokens, cfg: ModelConfig, *, active=None):
    """tokens [B] -> (logits [B, V_padded] f32, cache).

    ``active`` (optional [B] bool) is the per-slot termination state of the
    fused decode: inactive slots do not advance ``cache["lengths"]`` (their
    writes land past their valid length and stay invisible). The cache is
    updated in place and returned."""
    _check_family(cfg)
    lengths = cache["lengths"]
    x = _embed_tokens(params, cfg, tokens[:, None])[:, 0]
    adv = 1 if active is None else active.to(torch.int32)
    if cfg.family in ("ssm", "hybrid"):
        # every slot's recurrent state advances, active or not (as in
        # JAX); only ``lengths`` freezes, and the next admission
        # overwrites a finished slot's state
        x = (_ssm_decode if cfg.family == "ssm" else _hybrid_decode)(
            params, cache, x, cfg)
        cache["lengths"] = lengths + adv
        return _lm_logits(params, cfg, x), cache
    if "k_pool" in cache:
        # paged layout; the block table and lengths hold for the whole step
        table = cache["block_table"]
        for i in range(cfg.num_layers):
            lp = layer_params(params, i)
            x = _paged_attn_decode(lp, x, cache["k_pool"][i],
                                   cache["v_pool"][i], table, lengths, cfg)
            x = _ffn_decode(lp, x, cfg)
        cache["lengths"] = lengths + adv
        return _lm_logits(params, cfg, x), cache
    S = cache["k"].shape[2]
    ring_window = cfg.sliding_window if (
        cfg.sliding_window is not None and S == cfg.sliding_window) else None
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        x = _attn_decode(lp, x, cache["k"][i], cache["v"][i], lengths, cfg,
                         ring_window=ring_window)
        x = _ffn_decode(lp, x, cfg)
    cache["lengths"] = lengths + adv
    return _lm_logits(params, cfg, x), cache
