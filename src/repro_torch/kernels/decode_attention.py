"""Decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/decode_attention.py::decode_attention``
(the Pallas TPU kernel, contiguous cache) and of
``repro/kernels/ref.py::decode_attention_ref`` (its oracle). The kernel is
``csrc/decode_attention.cu``.

:func:`decode_attention` launches the kernel for CUDA tensors and takes the
plain version only for tensors that lie on the CPU; anything else raises.
``decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_Q_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8       # query heads per KV head the kernel holds
TILE = 64           # cache positions per tile of the kernel
# blocks per SM the split aims for: the kernel's launch bounds
# (MIN_BLOCKS in csrc/decode_attention.cu) keep four of them resident
BLOCKS_PER_SM = 4


def decode_attention_plain(q, k, v, lengths):
    """q [B, H, hd]; k, v [B, S, KV, hd]; lengths [B] -> [B, H, hd].

    Softmax over the first ``lengths[b]`` cache entries, in f32."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * hd ** -0.5
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def decode_splits(B: int, KV: int, S: int, n_sm: int):
    """(split_len, nsplit): how the kernel cuts a cache of ``S`` positions.

    Chosen from the shapes alone, never from the lengths (reading them on
    the host would sync every layer of every step): enough splits that the
    B * KV * nsplit blocks give each of the ``n_sm`` SMs ``BLOCKS_PER_SM``,
    each split a whole number of tiles."""
    tiles = max(1, -(-S // TILE))
    want = min(tiles, max(1, -(-BLOCKS_PER_SM * n_sm // (B * KV))))
    per = -(-tiles // want)
    return per * TILE, -(-tiles // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    fn = build.load("decode_attention").decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k, v, lengths):
    """q [B, H, hd]; k, v [B, S, KV, hd]; lengths [B] -> [B, H, hd].

    On CUDA: q f32 or bf16, k/v bf16, lengths int32, hd 64 or 128, at most
    ``MAX_GROUP`` query heads per KV head, all contiguous. The kernel
    reads ``lengths`` on the device; entries past a length are never read.
    One launch of the wrapper runs the split pass and its combine pass.
    """
    tensors = (q, k, v, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_plain(q, k, v, lengths)
    if not all(t.device.type == "cuda" and t.device == q.device
               for t in tensors):
        raise ValueError("decode_attention: q, k, v, lengths must all be on "
                         "one CUDA device (or all on the CPU)")
    if (q.dtype not in _Q_DTYPE_CODE or k.dtype != torch.bfloat16
            or v.dtype != torch.bfloat16 or lengths.dtype != torch.int32):
        raise ValueError(f"decode_attention: dtypes q {q.dtype}, k {k.dtype},"
                         f" v {v.dtype}, lengths {lengths.dtype}; need q "
                         "float32|bfloat16, k/v bfloat16, lengths int32")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or tuple(lengths.shape) != (B,)
            or KV == 0 or H % KV or H // KV > MAX_GROUP
            or hd not in (64, 128)):
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, lengths "
                         f"{tuple(lengths.shape)} (hd 64|128, H % KV == 0, "
                         f"H // KV <= {MAX_GROUP})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: inputs must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k/v must be 16-byte aligned")
    split_len, nsplit = decode_splits(B, KV, S, _sm_count(q.device.index))
    out = torch.empty_like(q)
    # per (b, head, split): acc [hd], then (m, l) for all of them. Freed on
    # return into the caching allocator, which hands it out again only in
    # this stream's order, after both kernels.
    ws = torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32,
                     device=q.device)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), ws.data_ptr(), B, H, KV, S, hd,
                _Q_DTYPE_CODE[q.dtype], split_len, nsplit,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (code {rc})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
