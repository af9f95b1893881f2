"""RWKV-6 WKV recurrence: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/rwkv6.py::wkv_scan`` (the Pallas TPU
kernel) and of ``repro/kernels/ref.py::rwkv6_ref`` (its oracle). The
kernel is ``csrc/rwkv6.cu``.

Layout: the JAX package's public one, ``[B, T, H, N]`` in and out (its
``ops.wkv_scan``); the CUDA kernel reads that layout as it is, so no
transpose is made. ``u`` is ``[H, N]`` and multiplies along the key index
``i``; the state ``S[i, j]`` accumulates ``k_i * v_j``.

:func:`wkv_scan` launches the kernel for CUDA tensors and takes the plain
version only for tensors that lie on the CPU; anything else raises.
``wkv_scan.launches`` counts kernel calls: one per call, though the
chunked scan is three launches (``csrc/rwkv6.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIM = 64   # the one N the kernel is built for (rwkv6-7b's)
CHUNK = 64      # the kernel's chunk of time steps (``csrc/rwkv6.cu``)


def wkv_scan_plain(r, k, v, w, u, s0=None):
    """r/k/v/w [B, T, H, N] f32; u [H, N]; s0 [B, H, N, N] ->
    (y [B, T, H, N], s_final [B, H, N, N]).

    The sequential recurrence, one step per time index, in f32
    (``ref.rwkv6_ref``)."""
    B, T, H, N = r.shape
    s = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    uu = u.float()[None, :, :, None]
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = k[:, t, :, :, None].float() * v[:, t, :, None, :].float()
        y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t].float(), s + uu * kv)
        s = w[:, t, :, :, None].float() * s + kv
    return y, s


def _lib():
    fn = build.load("rwkv6").wkv_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def wkv_scan(r, k, v, w, u, s0=None):
    """r/k/v/w [B, T, H, N]; u [H, N]; s0 [B, H, N, N] or None ->
    (y [B, T, H, N], s_final [B, H, N, N]).

    On CUDA: f32, contiguous, r/k/v/w 16-byte aligned, N =
    ``HEAD_DIM``, any T (no padding), any w in [0, 1]."""
    tensors = (r, k, v, w, u) if s0 is None else (r, k, v, w, u, s0)
    if all(t.device.type == "cpu" for t in tensors):
        return wkv_scan_plain(r, k, v, w, u, s0)
    if not all(t.device.type == "cuda" and t.device == r.device
               for t in tensors):
        raise ValueError("wkv_scan: r, k, v, w, u, s0 must all be on one "
                         "CUDA device (or all on the CPU)")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise ValueError(f"wkv_scan: dtypes "
                         f"{[str(t.dtype) for t in tensors]}; need float32")
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"wkv_scan: shapes {[tuple(t.shape) for t in tensors]}"
                         " (need r, k, v, w [B, T, H, N])")
    B, T, H, N = r.shape
    if (N != HEAD_DIM or tuple(u.shape) != (H, N)
            or (s0 is not None and tuple(s0.shape) != (B, H, N, N))):
        raise ValueError(f"wkv_scan: unsupported shapes "
                         f"{[tuple(t.shape) for t in tensors]} (N = "
                         f"{HEAD_DIM}, u [H, N], s0 [B, H, N, N])")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv_scan: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv_scan: r, k, v, w must be 16-byte aligned (the "
                         "kernel stages them with 16-byte copies)")
    y = torch.empty_like(r)
    s_final = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    # scratch of the chunked scan: each chunk's state and decay product
    nc = max(1, -(-T // CHUNK))
    d_state = torch.empty((B, H, nc, N, N), dtype=torch.float32,
                          device=r.device)
    decay = torch.empty((B, H, nc, N), dtype=torch.float32, device=r.device)
    rc = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if s0 is None else s0.data_ptr(),
                y.data_ptr(), s_final.data_ptr(), d_state.data_ptr(),
                decay.data_ptr(), B, T, H, N, CHUNK,
                torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv_scan kernel launch failed (code {rc})")
    wkv_scan.launches += 1
    return y, s_final


wkv_scan.launches = 0
