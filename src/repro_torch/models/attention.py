"""Attention compute paths (counterpart of ``repro/models/attention.py``).

- ``blockwise_attention`` — prefill/scoring. Contiguous-position blocks
  with no explicit position arrays and no soft-cap go to the flash kernel
  (``kernels/ops.py``); anything else takes the exact eager path, chunked
  over queries so the S x S score matrix is never built whole.
- ``decode_attention`` — one query token against a KV cache with
  per-sequence lengths. A linear cache (no ``kv_positions``, no soft-cap)
  goes to the decode kernel; a ring cache (``kv_positions``) takes the
  eager path.
- ``paged_decode_attention`` — the same against a paged KV pool reached
  through a block table; goes to the paged decode kernel unless a soft-cap
  is set.
- ``cache_write`` / ``paged_cache_write`` / ``ring_positions`` — the cache
  bookkeeping.

The kernel dispatch rule is the JAX package's (``attention.py:60-61,
128-129``); the kernels' own modules decide kernel or plain version by the
tensors' device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as _kops

F32 = torch.float32
NEG_INF = -1e30


def _soft_cap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_positions=None,
                        kv_positions=None, chunk: int = 512,
                        logit_cap: Optional[float] = None):
    """Exact attention. q [B, Sq, H, hd]; k, v [B, Skv, KV, hd] with
    H = KV * G; q_positions/kv_positions [B, S*] override the default
    arange. Returns [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    if q_positions is None and kv_positions is None and logit_cap is None:
        out = _kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=causal,
                                    window=window)
        return out.transpose(1, 2)

    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev).expand(B, Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev).expand(B, Skv)
    scale = hd ** -0.5
    kvp = kv_positions[:, None, None, None, :]                # [B,1,1,1,Skv]
    outs = []
    for c0 in range(0, Sq, chunk):
        qc = q[:, c0:c0 + chunk].reshape(B, -1, KV, G, hd)
        qpos = q_positions[:, c0:c0 + chunk][:, None, None, :, None]
        s = torch.einsum("bqkgh,bskh->bkgqs", qc.float(), k.float()) * scale
        s = _soft_cap(s, logit_cap)
        valid = qpos >= 0
        if causal:
            valid = valid & (qpos >= kvp)
        if window is not None:
            valid = valid & ((qpos - kvp) < window)
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
        outs.append(o.reshape(B, -1, H, hd).to(v.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, *, lengths, kv_positions=None,
                     logit_cap: Optional[float] = None):
    """One-token attention against a cache.

    q [B, H, hd]; k_cache, v_cache [B, S, KV, hd]; lengths [B] = number of
    valid cache entries. Ring caches pass ``kv_positions`` [B, S] (the
    absolute position in each slot, -1 = empty). Returns [B, H, hd]."""
    if kv_positions is None and logit_cap is None:
        return _kops.decode_attention(q, k_cache, v_cache, lengths)
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    # caches may be stored in a reduced type; compute upcasts to q's type
    kc = k_cache.to(q.dtype)
    vc = v_cache.to(q.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), kc.float()) * hd ** -0.5
    s = _soft_cap(s, logit_cap)
    if kv_positions is None:
        valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    else:
        valid = kv_positions >= 0
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(q.dtype).float(), vc.float())
    return o.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths, *,
                           logit_cap: Optional[float] = None):
    """One-token attention against a paged (block-table) cache.

    q [B, H, hd]; k_pool, v_pool [N, P, KV, hd] — N pages of P tokens;
    block_table [B, nb] maps each sequence's page index to a pool page
    (entries >= N mark unallocated pages, whose positions are always at or
    past the sequence length); lengths [B]. Returns [B, H, hd]. Without a
    soft-cap the pages go to the kernel as they lie; with one, they are
    gathered into a contiguous view for the eager path."""
    if logit_cap is None:
        return _kops.paged_decode_attention(q, k_pool, v_pool, block_table,
                                            lengths)
    N, P, KV, hd = k_pool.shape
    B, nb = block_table.shape
    bt = block_table.long().clamp(0, N - 1)
    kc = k_pool[bt].reshape(B, nb * P, KV, hd)
    vc = v_pool[bt].reshape(B, nb * P, KV, hd)
    return decode_attention(q, kc, vc, lengths=lengths, logit_cap=logit_cap)


def cache_write(k_cache, v_cache, k_new, v_new, lengths, *,
                ring: bool = False):
    """Write one token per sequence at its current length, IN PLACE (the
    JAX package returns updated arrays and donates the old ones; here the
    cache tensors are mutated and returned).

    k_new/v_new [B, KV, hd]; lengths [B]. ``ring=True`` wraps the index
    modulo the cache size. On a linear cache a write at ``lengths == S``
    (a full, masked slot) is dropped, as JAX drops out-of-bounds scatters;
    the index is clamped and the old entry written back, so no length is
    read on the host."""
    B, S = k_cache.shape[0], k_cache.shape[1]
    b = torch.arange(B, device=k_cache.device)
    if ring:
        idx = lengths % S
        k_cache[b, idx] = k_new.to(k_cache.dtype)
        v_cache[b, idx] = v_new.to(v_cache.dtype)
        return k_cache, v_cache
    idx = lengths.clamp(max=S - 1)
    keep = (lengths >= S)[:, None, None]
    k_cache[b, idx] = torch.where(keep, k_cache[b, idx],
                                  k_new.to(k_cache.dtype))
    v_cache[b, idx] = torch.where(keep, v_cache[b, idx],
                                  v_new.to(v_cache.dtype))
    return k_cache, v_cache


def paged_cache_write(k_pool, v_pool, k_new, v_new, block_table, lengths):
    """Write one token per sequence into its block-table page, IN PLACE.

    k_pool, v_pool [N + 1, P, KV, hd]: the N pages of the pool and, last,
    a trash page that nothing reads. k_new/v_new [B, KV, hd]; the write
    of sequence b lands in page ``block_table[b, lengths[b] // P]`` at
    offset ``lengths[b] % P``. A write past the table (a slot at
    ``max_seq``) or through a sentinel entry (outside [0, N)) goes to the
    trash page: the JAX package drops such scatters (``mode="drop"``),
    which PyTorch has no form of, and filtering the indices on the host
    would sync. Returns (k_pool, v_pool).

    Shared or prefix-cached pages are never written: the engine keeps
    every write at or past each slot's length and copy-on-writes the one
    replay write that could land in one (see the JAX package's
    ``attention.py:212-241``)."""
    N = k_pool.shape[0] - 1
    P = k_pool.shape[1]
    nb = block_table.shape[1]
    lengths = lengths.long()
    pi = torch.div(lengths, P, rounding_mode="floor")
    off = lengths - pi * P
    blk = torch.gather(block_table.long(), 1,
                       pi.clamp(max=nb - 1)[:, None])[:, 0]
    blk = torch.where((pi < nb) & (blk >= 0) & (blk < N), blk, N)
    k_pool[blk, off] = k_new.to(k_pool.dtype)
    v_pool[blk, off] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def ring_positions(lengths, window: int):
    """Absolute position held in each ring slot, -1 if empty. [B, window]."""
    slots = torch.arange(window, device=lengths.device)[None, :]   # [1, W]
    L = lengths[:, None].to(torch.int64)                           # [B, 1]
    # slot s holds the largest position p < L with p % W == s
    p = torch.div(L - 1 - slots, window, rounding_mode="floor") * window \
        + slots
    return torch.where((p >= 0) & (p < L) & (p > L - 1 - window), p, -1)
