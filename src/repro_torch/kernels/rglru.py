"""RG-LRU linear recurrence: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/rglru.py::rglru_scan`` (the Pallas TPU
kernel) and of ``repro/kernels/ref.py::rglru_ref`` (its oracle). The
kernel is ``csrc/rglru.cu``: a scan split over time inside each block,
segments of :data:`SEGMENT` steps, :data:`WARPS` segments a round.

:func:`rglru_scan` launches the kernel for CUDA tensors and takes the
plain version only for tensors that lie on the CPU; anything else raises.
``rglru_scan.launches`` counts kernel launches, and
``rglru_scan.launches_at`` the same launches by shape ``(B, S, W)``.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import build

SEGMENT = 8     # steps a segment, one warp's share (``csrc/rglru.cu``: K)
WARPS = 32      # segments a round, at most (``csrc/rglru.cu``: NW)
ROUND = SEGMENT * WARPS


def rglru_scan_plain(a, b, h0=None):
    """a, b [B, S, W] f32; h0 [B, W] -> (h [B, S, W], h_last [B, W]).

    The sequential recurrence ``h_t = a_t * h_{t-1} + b_t`` in f32, one
    step per time index (``ref.rglru_ref``); ``h_last`` is ``h0`` (zeros
    by default) when S is 0."""
    B, S, W = a.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    out = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h
    return out, h


def _lib():
    fn = build.load("rglru").rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rglru_scan(a, b, h0=None):
    """a, b [B, S, W]; h0 [B, W] or None -> (h [B, S, W], h_last [B, W]).

    On CUDA: f32, contiguous, any S and W (no padding)."""
    tensors = (a, b) if h0 is None else (a, b, h0)
    if all(t.device.type == "cpu" for t in tensors):
        return rglru_scan_plain(a, b, h0)
    if not all(t.device.type == "cuda" and t.device == a.device
               for t in tensors):
        raise ValueError("rglru_scan: a, b, h0 must all be on one CUDA "
                         "device (or all on the CPU)")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise ValueError(f"rglru_scan: dtypes "
                         f"{[str(t.dtype) for t in tensors]}; need float32")
    if a.dim() != 3 or a.shape != b.shape or (
            h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2])):
        raise ValueError(f"rglru_scan: shapes {[tuple(t.shape) for t in tensors]}"
                         " (need a, b [B, S, W] and h0 [B, W])")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru_scan: a, b, h0 must be contiguous")
    B, S, W = a.shape
    h = torch.empty_like(a)
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    rc = _lib()(a.data_ptr(), b.data_ptr(),
                None if h0 is None else h0.data_ptr(), h.data_ptr(),
                h_last.data_ptr(), B, S, W,
                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed (code {rc})")
    rglru_scan.launches += 1
    rglru_scan.launches_at[(B, S, W)] += 1
    return h, h_last


rglru_scan.launches = 0
rglru_scan.launches_at = Counter()
