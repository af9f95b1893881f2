"""Grouped matmul (the MoE expert compute): the CUDA kernel's wrapper and
its plain version.

Counterpart of ``repro/kernels/gmm.py::gmm`` (the Pallas TPU kernel) and
of ``repro/kernels/ref.py::gmm_ref`` (its oracle). The kernel is
``csrc/gmm.cu``.

:func:`gmm` launches the kernel for CUDA tensors and takes the plain
version only for tensors that lie on the CPU; anything else raises.
``gmm.launches`` counts kernel launches, and ``gmm.launches_at`` the same
launches by shape ``(E, C, d, f)``: the kernel takes one of two paths by
C (``csrc/gmm.cu``).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import build


def gmm_plain(x, w):
    """x [E, C, d]; w [E, d, f] -> [E, C, f]: one product per expert,
    summed in f32 and cast back to x's dtype (``ref.gmm_ref``)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def _lib():
    fn = build.load("gmm").gmm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gmm(x, w):
    """x [E, C, d]; w [E, d, f] -> [E, C, f].

    On CUDA: f32 (the port's parameter type; nothing is converted),
    contiguous, any E, C, d and f (no padding)."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return gmm_plain(x, w)
    if not (x.device.type == "cuda" and w.device == x.device):
        raise ValueError("gmm: x and w must be on one CUDA device (or both "
                         "on the CPU)")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"gmm: dtypes {x.dtype}, {w.dtype}; need float32")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"gmm: shapes {tuple(x.shape)}, {tuple(w.shape)} "
                         "(need x [E, C, d] and w [E, d, f])")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm: x and w must be contiguous")
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    rc = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gmm kernel launch failed (code {rc})")
    gmm.launches += 1
    gmm.launches_at[(E, C, d, f)] += 1
    return out


gmm.launches = 0
gmm.launches_at = Counter()
