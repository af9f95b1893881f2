"""Rules of the PyTorch port, checked statically and on the CPU:

- nothing under ``src/repro_torch/``, in ``chip_smoke.py`` or in
  ``chip_ab.py`` imports JAX or the JAX package (``repro``), and importing
  the port loads neither;
- entry points default to ``device="cuda"`` and raise without a GPU
  (no silent CPU fallback), the HTTP front's build path included;
- each kernel's CUDA source names the TPU kernel it replaces, and the
  kernel modules call no library attention.
"""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                     ROOT / "chip_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.core.service, "
            "repro_torch.core.assets, repro_torch.models.convert, "
            "repro_torch.core.api, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _device_entry_points():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.core.assets import _EngineWrapper
    from repro_torch.core.deployment import DeploymentManager
    from repro_torch.device import resolve_device
    from repro_torch.models import convert, transformer
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import GenerationEngine
    model = build_model(reduce_for_smoke(get_config("qwen3-4b")))
    return (resolve_device, GenerationEngine.__init__,
            _EngineWrapper.__init__, transformer.init_params,
            transformer.init_cache, convert.to_torch_params, model.init,
            model.init_cache, DeploymentManager.deploy)


def test_entry_points_default_to_cuda():
    for fn in _device_entry_points():
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.core.assets import EXCHANGE
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EXCHANGE.get("qwen3-4b").build()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.models.convert import to_torch_params
    from repro_torch.models.model import build_model
    model = build_model(reduce_for_smoke(get_config("qwen3-4b")))
    from repro_torch.core.api import MAXServer
    server = MAXServer(build_kw={"max_seq": 32})
    for call in (model.init, lambda: model.init_cache(1, 8),
                 lambda: model.init_cache(1, 32, paged=(4, 16)),
                 lambda: to_torch_params({"embed": [[0.0]]}),
                 lambda: server.manager.deploy("qwen3-4b",
                                               **server.build_kw),
                 lambda: EXCHANGE.get("qwen3-4b").build(paged=True,
                                                        prefix_cache=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    server.stop()
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_rejects_params_of_another_shape():
    import numpy as np
    from repro_torch.core.assets import EXCHANGE
    w = EXCHANGE.get("qwen3-4b").build(device="cpu", max_seq=32)
    params = {k: v for k, v in w.params.items()}
    params["embed"] = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError, match="embed"):
        EXCHANGE.get("qwen3-4b").build(device="cpu", max_seq=32,
                                       params=params)


def test_kernel_sources_name_their_tpu_kernel_and_use_no_library():
    from repro_torch.kernels import build
    for name in build.SOURCES:
        src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
        assert f"repro/kernels/{name}.py::" in src
        for entry in build.ENTRY_POINTS[name]:
            assert f'extern "C" int {entry}(' in src
            kernel = entry[:-len("_fwd")]
            assert f"repro/kernels/{name}.py::{kernel}" in src
        assert "sm_90a" in src
        assert 'extern "C"' in src
        mod = (PORT / "kernels" / f"{name}.py").read_text()
        assert "scaled_dot_product_attention" not in mod
        assert "_plain" in mod and ".launches += 1" in mod
    mod = (PORT / "kernels" / "decode_attention.py").read_text()
    assert "paged_decode_attention.launches += 1" in mod
    assert "def paged_decode_attention_plain" in mod


def test_recurrent_modules_import_no_jax():
    code = ("import sys; import repro_torch.models.rglru, "
            "repro_torch.models.rwkv6, repro_torch.kernels.rglru, "
            "repro_torch.kernels.rwkv6, repro_torch.flags; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if PORT in
               p.parents}
    assert {"models/rglru.py", "models/rwkv6.py", "kernels/rglru.py",
            "kernels/rwkv6.py", "flags.py", "configs/recurrentgemma_9b.py",
            "configs/rwkv6_7b.py"} <= scanned


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "rwkv6-7b"])
def test_recurrent_families_default_to_cuda(name):
    """The hybrid and SSM models' entry points default to ``cuda`` and
    raise without a GPU, like the dense family's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.core.assets import EXCHANGE
    from repro_torch.models.model import build_model
    model = build_model(reduce_for_smoke(get_config(name)))
    for fn in (model.init, model.init_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for call in (model.init, lambda: model.init_cache(1, 32),
                 lambda: EXCHANGE.get(name).build(),
                 lambda: EXCHANGE.get(name).build(paged=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_recurrent_kernel_sources_and_wrappers():
    """The two recurrent kernels: each source names its TPU kernel, its
    module keeps the plain version and a launch counter, and neither
    module calls a library scan."""
    from repro_torch.kernels import build
    assert build.ENTRY_POINTS["rglru"] == ("rglru_scan_fwd",)
    assert build.ENTRY_POINTS["rwkv6"] == ("wkv_scan_fwd",)
    for name, fn in (("rglru", "rglru_scan"), ("rwkv6", "wkv_scan")):
        src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
        assert f"repro/kernels/{name}.py::{fn}" in src
        mod = (PORT / "kernels" / f"{name}.py").read_text()
        assert f"def {fn}_plain(" in mod and f"{fn}.launches += 1" in mod
        assert "cumsum" not in mod and "cumprod" not in mod


def test_moe_modules_import_no_jax():
    code = ("import sys; import repro_torch.models.moe, "
            "repro_torch.kernels.gmm, repro_torch.configs.phi35_moe_42b_a66b, "
            "repro_torch.configs.qwen3_moe_235b_a22b; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    scanned = {p.relative_to(PORT).as_posix() for p in FILES if PORT in
               p.parents}
    assert {"models/moe.py", "kernels/gmm.py", "configs/phi35_moe_42b_a66b.py",
            "configs/qwen3_moe_235b_a22b.py"} <= scanned


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_assets_default_to_cuda(name):
    """The MoE models' and assets' entry points default to ``cuda`` and
    raise without a GPU, like the other families'."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.core.assets import EXCHANGE
    from repro_torch.models.model import build_model
    model = build_model(reduce_for_smoke(get_config(name)))
    for fn in (model.init, model.init_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert EXCHANGE.get(name).metadata.type == "Text Generation"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for call in (model.init, lambda: model.init_cache(1, 32),
                 lambda: EXCHANGE.get(name).build(),
                 lambda: EXCHANGE.get(name).build(paged=True,
                                                  prefix_cache=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_gmm_kernel_source_and_wrapper_use_no_library_gemm():
    """``gmm.cu`` names its TPU kernel, targets sm_90a and calls no library
    GEMM; its tensor-core path is 3xTF32 only: every ``mma.sync`` is a TF32
    m16n8k8, each operand is split into a high part rounded to TF32
    (nearest, ties away, as ``cvt.rna.tf32.f32``) and the f32 rest, and
    every product is the three terms, never one TF32 pass. The wrapper keeps the plain version and a
    launch counter and launches only the hand-written kernel."""
    import re
    from repro_torch.kernels import build
    assert build.ENTRY_POINTS["gmm"] == ("gmm_fwd",)
    csrc = PORT / "kernels" / "csrc"
    src = (csrc / "gmm.cu").read_text()
    assert "repro/kernels/gmm.py::gmm" in src and "sm_90a" in src
    # the TF32 split and MMA live in the header gmm.cu includes (shared
    # with flash_attention.cu): the source as compiled is both
    assert '#include "tf32_mma.cuh"' in src
    src += (csrc / "tf32_mma.cuh").read_text()
    for lib in ("cublas", "cutlass", "#include <torch", "wmma"):
        assert lib not in src.lower(), lib
    code = re.sub(r"//[^\n]*", "", src)      # the source without comments
    mmas = re.findall(r'"mma\.sync[^"]*"', code)
    assert mmas == ['"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "']
    # the split: hi rounded to TF32, lo = v - hi exact in f32 (the MMA
    # reads its top 19 bits)
    assert "(__float_as_uint(v) + 0x1000u) & 0xffffe000u" in code
    assert "hi = tf32_rna(v);" in code
    assert "lo = __float_as_uint(v - __uint_as_float(hi));" in code
    # each accumulation is the three terms, small ones first
    calls = re.findall(r"mma_tf32\(([^;]*)\);", code)
    assert calls == ["part[i][j], alo[i], bhi", "part[i][j], ahi[i], blo",
                     "part[i][j], ahi[i], bhi"], calls
    mod = (PORT / "kernels" / "gmm.py").read_text()
    assert "def gmm_plain(" in mod and "gmm.launches += 1" in mod
    # the count by shape sits beside the launch count, nowhere else
    assert mod.count("gmm.launches_at[") == 1
    assert "gmm.launches += 1\n    gmm.launches_at[(E, C, d, f)] += 1" in mod
    wrapper = mod[mod.index("def gmm(x, w)"):]
    for call in ("bmm", "matmul", "einsum", " @ "):
        assert call not in wrapper, call


def test_decode_kernel_source_and_wrappers_use_no_library():
    """``decode_attention.cu`` calls no library kernel (no cuBLAS, CUTLASS,
    PyTorch headers or WMMA) and runs each call as one launch: one
    ``<<<`` in the source; the wrappers launch only through its C entry
    points and never reach a PyTorch attention call."""
    import re
    src = (PORT / "kernels" / "csrc" / "decode_attention.cu").read_text()
    for lib in ("cublas", "cutlass", "#include <torch", "wmma"):
        assert lib not in src.lower(), lib
    code = re.sub(r"//[^\n]*", "", src)
    assert code.count("<<<") == 1
    mod = (PORT / "kernels" / "decode_attention.py").read_text()
    for name in ("decode_attention", "paged_decode_attention"):
        wrapper = mod[mod.index(f"def {name}(q"):]
        wrapper = wrapper[:wrapper.index(f"{name}.launches = 0")]
        assert wrapper.count(f"{name}.launches += 1") == 1
        for call in ("scaled_dot_product_attention", "softmax", "einsum",
                     "matmul", " @ "):
            assert call not in wrapper, (name, call)

def test_build_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """A kernel library is named by its source, the headers it includes
    from ``csrc/`` (followed through headers) and the flags: an edited
    header rebuilds, an unchanged tree reuses."""
    from repro_torch.kernels import build
    assert [p.name for p in build._sources("gmm")] == ["gmm.cu",
                                                        "tf32_mma.cuh"]
    assert [p.name for p in build._sources("flash_attention")] == [
        "flash_attention.cu", "tf32_mma.cuh"]
    assert [p.name for p in build._sources("rwkv6")] == ["rwkv6.cu"]
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n#include <stdint.h>\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("// one\n")
    first = build._target("a")
    assert build._target("a") == first
    (tmp_path / "c.cuh").write_text("// two\n")
    second = build._target("a")
    assert second != first
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n// x\n')
    assert build._target("a") not in (first, second)


def test_flash_kernel_source_is_3xtf32_on_the_tensor_cores():
    """``flash_attention.cu`` takes both products on the tensor cores in
    3xTF32 from the shared header: f32 operands split, the three terms in
    two accumulators added small ones first (the second small term only
    when the staged type is f32: bf16 is exact in TF32), P from the score
    registers (no shared buffer for P), and no library."""
    import re
    src = (PORT / "kernels" / "csrc" / "flash_attention.cu").read_text()
    assert '#include "tf32_mma.cuh"' in src
    code = re.sub(r"//[^\n]*", "", src)
    for lib in ("cublas", "cutlass", "#include <torch", "wmma", "sP["):
        assert lib not in code, lib
    assert "mma.sync" not in code           # only through mma_tf32
    calls = re.findall(r"mma_tf32\(([^;]*)\);", code)
    assert calls == ["small[j], alo, bhi", "small[j], ahi, blo",
                     "part[j], ahi, bhi", "small, plo[kk], bhi",
                     "small, phi[kk], blo", "part, phi[kk], bhi"], calls
    # the small terms' sum is added first
    assert "s[j][r] += small[j][r] + part[j][r];" in code
    assert "o[n][r] += small[r] + part[r];" in code
    assert "split_tf32(p[kk][" in code      # P is always split


def test_faults_module_is_the_reference_copy():
    """``serving/faults.py`` is the JAX package's module, statement for
    statement, with the port's imports: pure Python (no torch, numpy or
    JAX), so the same spec and seed fire the same faults in both."""
    port = (PORT / "serving" / "faults.py").read_text()
    ref = (ROOT / "src" / "repro" / "serving" / "faults.py").read_text()
    tree = ast.parse(port)
    roots = set(_imported_roots(tree))
    assert roots <= {"__future__", "random", "threading", "time",
                     "collections", "dataclasses", "typing", "repro_torch"}

    def body(src):
        mod = ast.parse(src)
        return ast.dump(ast.Module(body=mod.body[1:], type_ignores=[]))
    assert body(port.replace("repro_torch.", "repro.")) == body(ref)
