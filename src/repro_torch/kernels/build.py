"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Builds happen at first use (never at import), into
``kernels/_build/`` inside the checkout, named by a hash of the source, the
headers it includes from ``csrc/`` and the flags, so an edited source or
header rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# each source and the plain C entry points its library must export
ENTRY_POINTS: Dict[str, Tuple[str, ...]] = {
    "flash_attention": ("flash_attention_fwd",),
    "decode_attention": ("decode_attention_fwd",
                         "paged_decode_attention_fwd"),
    "rglru": ("rglru_scan_fwd",),
    "rwkv6": ("wkv_scan_fwd",),
    "gmm": ("gmm_fwd",),
}
SOURCES = tuple(ENTRY_POINTS)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills) of
#: each source built by this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str):
    """``csrc/<name>.cu`` and every header it includes from ``csrc/``
    (``#include "..."``, followed through headers), in include order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc.decode() for inc in
                 _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]):
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    tmp.replace(_target(name))


def build_all(names: Tuple[str, ...] = SOURCES) -> None:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together."""
    with _lock:
        procs = [(n, _start(n)) for n in names]
        for n, p in procs:
            _finish(n, p)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            missing = [f for f in ENTRY_POINTS[name] if not hasattr(lib, f)]
            if missing:
                raise RuntimeError(f"{name}.cu built without {missing}")
            _libs[name] = lib
        return _libs[name]
