"""Padding and dispatch in front of the kernels (counterpart of
``repro/kernels/ops.py``).

The JAX package picks a backend with a global switch; here the tensors'
device decides: CUDA tensors launch the kernel, CPU tensors take its
plain version (see each kernel module). Padding rules follow the JAX
package where the kernel needs them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.decode_attention import (
    paged_decode_attention as _paged_decode,
)
from repro_torch.kernels.flash_attention import BLOCK
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.gmm import gmm as _gmm
from repro_torch.kernels.rglru import rglru_scan as _rglru
from repro_torch.kernels.rwkv6 import wkv_scan as _wkv


def _pad_to(x, axis: int, multiple: int):
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``multiple``."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    return F.pad(x, [0, 0] * (x.dim() - 1 - axis) + [0, pad])


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0):
    """q [B, H, Sq, hd]; k, v [B, KV, Skv, hd] -> [B, H, Sq, hd].

    Pads Sq / Skv to the kernel's tile (``BLOCK`` rows) and masks the
    padded key columns with ``kv_len`` (``ops.py:58-65`` of the JAX
    package, which pads to its own 128-row blocks)."""
    Sq, Skv = q.shape[2], k.shape[2]
    qp = _pad_to(q.contiguous(), 2, BLOCK)
    kp = _pad_to(k.contiguous(), 2, BLOCK)
    vp = _pad_to(v.contiguous(), 2, BLOCK)
    out = _flash(qp, kp, vp, causal=causal, window=window, q_offset=q_offset,
                 kv_len=Skv)
    return out[:, :, :Sq]


def decode_attention(q, k, v, lengths):
    """q [B, H, hd]; k, v [B, S, KV, hd]; lengths [B] -> [B, H, hd].

    The JAX package pads S to its 256-entry block (``ops.py:72-77``); the
    CUDA kernel ends its loop at each sequence's length (<= S) and masks
    its last tile itself, so the cache is passed as it is — no copy."""
    return _decode(q.contiguous(), k, v, lengths.to(torch.int32))


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths):
    """q [B, H, hd]; k_pool, v_pool [N, P, KV, hd]; block_table [B, nb];
    lengths [B] -> [B, H, hd]. No padding: the page is the block
    (``ops.py:80-88`` of the JAX package), and the kernel takes any page
    size."""
    return _paged_decode(q.contiguous(), k_pool, v_pool,
                         block_table.to(torch.int32),
                         lengths.to(torch.int32))


def rglru_scan(a, b, h0=None):
    """a, b [B, S, W] -> (h [B, S, W], h_last [B, W]).

    The JAX package pads S to its 128-step time block with a = b = 0 and
    then reads ``h_last`` at S - 1 (``ops.py:91-105``); the CUDA kernel
    takes any S and W, so nothing is padded and ``h_last`` is the state
    after the last true step (``h0`` when S is 0)."""
    return _rglru(a.contiguous(), b.contiguous(),
                  None if h0 is None else h0.contiguous())


def wkv_scan(r, k, v, w, u, s0=None):
    """r/k/v/w [B, T, H, N]; u [H, N]; s0 [B, H, N, N] ->
    (y [B, T, H, N], s_final [B, H, N, N]).

    The JAX package transposes to ``[B, H, T, N]`` and pads T to its
    128-step block with w = 1, k = 0 (``ops.py:108-123``); the CUDA kernel
    reads the ``[B, T, H, N]`` layout as it is and takes any T, so
    neither happens here."""
    return _wkv(r.contiguous(), k.contiguous(), v.contiguous(),
                w.contiguous(), u.contiguous(),
                None if s0 is None else s0.contiguous())


def gmm(x, w):
    """x [E, C, d]; w [E, d, f] -> [E, C, f].

    The JAX package zero-pads C to its 128-row block and d, f to 256 / 128
    (``ops.py:125-137``); the CUDA kernel bounds-checks every edge, so
    nothing is padded here."""
    return _gmm(x.contiguous(), w.contiguous())
