"""Optimisation flags the port reads (counterpart of ``repro/flags.py``).

- chunked_wkv : RWKV-6 prefill on the CPU takes the chunked-parallel WKV
                (``models/rwkv6.py::_wkv_chunked``) instead of the
                per-token scan. On CUDA the ``wkv_scan`` kernel runs
                either way, as the JAX package's Pallas kernel does.

The JAX package's other flags (``carry_cache``, ``donate``,
``gather_weights``, ``uniform_decode``) steer XLA's buffers and sharding;
the port has no counterpart of them yet.
"""

from __future__ import annotations

_FLAGS = {
    "chunked_wkv": True,
}


def enabled(name: str) -> bool:
    return _FLAGS[name]


def set_flag(name: str, value: bool):
    assert name in _FLAGS, name
    _FLAGS[name] = value
