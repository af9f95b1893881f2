"""Prefill flash attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/flash_attention.py`` (the Pallas TPU
kernel) and of ``repro/kernels/ref.py::attention_ref`` (its oracle). The
kernel is ``csrc/flash_attention.cu``.

:func:`flash_attention` launches the kernel for CUDA tensors and takes the
plain version only for tensors that lie on the CPU; anything else raises.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BLOCK = 64          # the kernel's query and key tile
HEAD_DIMS = (64, 128, 256)   # the head dims the kernel is built for


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          kv_len: Optional[int] = None):
    """q [B, H, Sq, hd]; k, v [B, KV, Skv, hd] -> [B, H, Sq, hd].

    Full-matrix softmax attention in f32 (small shapes only). Key columns
    at or past ``kv_len`` are masked; a row with no visible key gives 0.
    """
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    kv_len = Skv if kv_len is None else kv_len
    qg = q.reshape(B, KV, G, Sq, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * hd ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window is not None:
        mask = mask & ((q_pos - k_pos) < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def _lib():
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None):
    """q [B, H, Sq, hd]; k, v [B, KV, Skv, hd] -> [B, H, Sq, hd].

    On CUDA: f32 or bf16, hd in ``HEAD_DIMS``, Sq and Skv multiples of 64
    (the caller pads, see ``ops.flash_attention``), contiguous. ``kv_len``
    (default Skv) masks padded key columns.
    """
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, kv_len=kv_len)
    if not all(t.device.type == "cuda" and t.device == q.device
               for t in tensors):
        raise ValueError("flash_attention: q, k, v must all be on one CUDA "
                         "device (or all on the CPU)")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; need one of float32, bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV
            or hd not in HEAD_DIMS or Sq % BLOCK or Skv % BLOCK):
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)} (hd in "
                         f"{HEAD_DIMS}, Sq and Skv multiples of {BLOCK}, "
                         "H % KV == 0)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [0, {Skv}]")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be > 0")
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, KV, Sq, Skv, hd, _DTYPE_CODE[q.dtype], int(causal),
                0 if window is None else int(window), int(q_offset), kv_len,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
