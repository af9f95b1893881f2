"""Decode attention: the CUDA kernels' wrappers and their plain versions.

Counterparts of ``repro/kernels/decode_attention.py::decode_attention``
(the Pallas TPU kernel, contiguous cache) and
``::paged_decode_attention`` (the same over a paged KV pool), and of their
oracles ``repro/kernels/ref.py::decode_attention_ref`` /
``paged_decode_attention_ref``. Both kernels are in
``csrc/decode_attention.cu``.

:func:`decode_attention` and :func:`paged_decode_attention` launch their
kernel for CUDA tensors and take the plain version only for tensors that
lie on the CPU; anything else raises. Each wrapper's ``launches`` counts
its kernel launches: one per call, the split pass and the combine in one
kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_Q_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8       # query heads per KV head the kernel holds
TILE = 32           # cache positions per block step of the kernel
# blocks per SM the split aims for: the kernel's launch bounds and shared
# memory (csrc/decode_attention.cu) keep two of them resident
BLOCKS_PER_SM = 2


def decode_attention_plain(q, k, v, lengths):
    """q [B, H, hd]; k, v [B, S, KV, hd]; lengths [B] -> [B, H, hd].

    Softmax over the first ``lengths[b]`` cache entries, in f32. A length
    of 0 gives zeros, as the Pallas kernels and the CUDA kernels do
    (``kernels/ref.py`` would average V there)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * hd ** -0.5
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    # masked entries already weigh exp(-1e30 - m) == 0 beside a visible
    # one; the mask only changes a row with none visible
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, block_table, lengths):
    """q [B, H, hd]; k_pool, v_pool [N, P, KV, hd]; block_table [B, nb]
    (entries >= N are sentinels); lengths [B] -> [B, H, hd].

    Gathers each sequence's pages (sentinels clamped to a real page, whose
    rows lie past the length and are masked) into a contiguous cache and
    runs :func:`decode_attention_plain`, as ``kernels/ref.py`` does."""
    N, P, KV, hd = k_pool.shape
    B, nb = block_table.shape
    bt = block_table.long().clamp(0, N - 1)
    k = k_pool[bt].reshape(B, nb * P, KV, hd)
    v = v_pool[bt].reshape(B, nb * P, KV, hd)
    return decode_attention_plain(q, k, v, lengths)


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


def _entry(name: str, n_ptr: int, n_int: int):
    """A C entry point of the decode library, its argument types set: the
    pointers, then the ints, then the stream."""
    fn = getattr(build.load("decode_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_ws_lock = threading.Lock()
# (device index, stream) -> [buffer, words at its start known to be zero]
_ws_cache = {}


def _workspace(q, nsplit):
    """Scratch of the kernel: B * H split counters, which must be zero when
    it starts (it leaves them zero), then the f32 partials, per (b, head,
    split) acc [hd], then (m, l) for all.

    One buffer per device and stream, kept across calls, so the counters
    need no launch of their own: only a call whose B * H exceeds the last
    call's zeroes them (the words past the last B * H held partials)."""
    B, H, hd = q.shape
    nctr = B * H
    need = nctr * (1 + nsplit * (hd + 2))
    key = (q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    with _ws_lock:
        buf, zero = _ws_cache.get(key, (None, 0))
        if buf is None or buf.numel() < need:
            buf = torch.zeros(need, dtype=torch.float32, device=q.device)
        elif zero < nctr:
            buf[:nctr].zero_()
        _ws_cache[key] = (buf, nctr)
    return buf


def _launch_contiguous(q, k, v, lengths, out, split_len, nsplit):
    """Run the contiguous kernel into ``out`` at the given split, on the
    current stream; the inputs are checked by the caller. Raises if the
    kernel refuses the call or does not launch."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    ws = _workspace(q, nsplit)
    fwd = _entry("decode_attention_fwd", 6, 8)
    rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), ws.data_ptr(), B, H, KV, S, hd,
             _Q_DTYPE_CODE[q.dtype], split_len, nsplit,
             torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (code "
                           f"{rc}; split {split_len} x {nsplit})")


def _launch_paged(q, k_pool, v_pool, block_table, lengths, out, split_len,
                  nsplit):
    """Run the paged kernel into ``out`` at the given split, on the
    current stream; the inputs are checked by the caller. Raises if the
    kernel refuses the call or does not launch."""
    B, H, hd = q.shape
    N, P, KV = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    nb = block_table.shape[1]
    ws = _workspace(q, nsplit)
    fwd = _entry("paged_decode_attention_fwd", 7, 10)
    rc = fwd(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             ws.data_ptr(), B, H, KV, N, P, nb, hd, _Q_DTYPE_CODE[q.dtype],
             split_len, nsplit,
             torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(code {rc}; split {split_len} x {nsplit})")


def decode_attention(q, k, v, lengths):
    """q [B, H, hd]; k, v [B, S, KV, hd]; lengths [B] -> [B, H, hd].

    On CUDA: q f32 or bf16, k/v bf16, lengths int32, hd 64 or 128, at most
    ``MAX_GROUP`` query heads per KV head, all contiguous. The kernel
    reads ``lengths`` on the device; entries past a length are never read.
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
    _launch_contiguous(q, k, v, lengths, out, split_len, nsplit)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths):
    """q [B, H, hd]; k_pool, v_pool [N, P, KV, hd]; block_table [B, nb];
    lengths [B] -> [B, H, hd].

    On CUDA: q f32 or bf16, pools bf16, block_table and lengths int32, hd
    64 or 128, at most ``MAX_GROUP`` query heads per KV head, all
    contiguous, any page size. Table entries outside [0, N) are sentinels
    (clamped on the device, never dereferenced as they are); positions at
    or past a length are never read. The split is sized from B, KV and
    ``nb * P`` alone, so no length reaches the host.
    """
    tensors = (q, k_pool, v_pool, block_table, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_decode_attention_plain(q, k_pool, v_pool, block_table,
                                            lengths)
    if not all(t.device.type == "cuda" and t.device == q.device
               for t in tensors):
        raise ValueError("paged_decode_attention: q, pools, block_table, "
                         "lengths must all be on one CUDA device (or all on "
                         "the CPU)")
    if (k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16
            or block_table.dtype != torch.int32
            or lengths.dtype != torch.int32):
        raise ValueError(f"paged_decode_attention: dtypes pools "
                         f"{k_pool.dtype}/{v_pool.dtype}, block_table "
                         f"{block_table.dtype}, lengths {lengths.dtype}; "
                         "need bfloat16 pools, int32 table and lengths")
    if (q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape
            or block_table.dim() != 2):
        raise ValueError(f"paged_decode_attention: shapes q "
                         f"{tuple(q.shape)}, pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)}, block_table "
                         f"{tuple(block_table.shape)}")
    B, H, hd = q.shape
    N, P, KV = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    nb = block_table.shape[1]
    if (q.dtype not in _Q_DTYPE_CODE or KV == 0 or H % KV
            or H // KV > MAX_GROUP or hd not in (64, 128)):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} "
                         f"{q.dtype} with {KV} KV heads: need q "
                         "float32|bfloat16, hd 64|128, H % KV == 0, "
                         f"H // KV <= {MAX_GROUP}")
    if (k_pool.shape[3] != hd or block_table.shape[0] != B
            or tuple(lengths.shape) != (B,) or N == 0 or P == 0 or nb == 0):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}, block_table "
                         f"{tuple(block_table.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not fit together")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention: pools must be 16-byte "
                         "aligned")
    split_len, nsplit = decode_splits(B, KV, nb * P,
                                      _sm_count(q.device.index))
    out = torch.empty_like(q)
    _launch_paged(q, k_pool, v_pool, block_table, lengths, out, split_len,
                  nsplit)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
