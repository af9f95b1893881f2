"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, started together) and print the card's name and power
   limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's full-width shapes and at small ones;
3. drive the main path: full-width ``qwen3-4b`` (random weights from a
   seed) built through the exchange on ``cuda`` and served by
   ``BatchedService`` to concurrent greedy requests and one sampled one;
   check every result, the batch sharing, the kernels' launch counts, and
   that a decode chunk makes no host sync;
4. print ``{"kernels": [...]}`` with each kernel's launches on the main
   path, its error against the plain version, and its time, the plain
   version's time, the bound and a library call's time, all measured here;
5. print ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX and nothing of the JAX package. Without a GPU,
or without the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device
# memory bandwidth, and f32 (CUDA cores) / bf16 (tensor cores) rates.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# tolerances of the repo's kernel tests (tests/test_kernels.py)
TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, each timed by its
    own CUDA events with a cold L2: a 256 MB buffer is rewritten before
    each call (untimed), as the main path's weight stream evicts a layer's
    inputs between its launches. A spin kernel first holds the device
    while the host queues every call, so host time does not show."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(2_000_000 * iters)       # ~1 ms per call at ~2 GHz
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def check_close(name: str, got, want, dtype_name: str) -> float:
    import torch
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype_name]
    ok = torch.allclose(got.float(), want.float(), **tol)
    log(f"  {name}: max_abs_err {err:.3e}  (tolerance atol {tol['atol']:g} "
        f"rtol {tol['rtol']:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def flash_flops(B, H, Sq, hd, kv_len, q_offset, causal, window):
    """Operations the flash function needs for these inputs: 4*hd per
    visible (query, key) pair and head (q.k and p.v, a multiply and an add
    each)."""
    pairs = 0
    for i in range(Sq):
        qp = q_offset + i
        hi = min(kv_len, qp + 1) if causal else kv_len
        lo = max(0, qp - window + 1) if window is not None else 0
        pairs += max(0, hi - lo)
    return pairs * 4 * hd * H * B


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    import torch
    from repro_torch.kernels import build
    log("== phase 1: build")
    t0 = time.perf_counter()
    build.build_all()
    log(f"  built {', '.join(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  [{name}] {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: no output"
    log(f"  device: {torch.cuda.get_device_name(0)}; {card}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(cfg):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    log("== phase 2: kernels vs plain versions")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.sliding_window
    out = {}

    # -- flash: full-width prefill buckets through ops (pads to 64), then
    #    small shapes straight into the wrapper
    flash_err = 0.0
    for Sq in (16, 128, 2048):
        q, k, v = randn(1, H, Sq, hd), randn(1, KV, Sq, hd), randn(1, KV, Sq, hd)
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        flash_err = max(flash_err, check_close(
            f"flash qwen3-4b Sq={Sq} f32", got, want, "float32"))
    for (B, h, kv, S, d, dt, causal, win, qoff, kvl) in (
            (2, 4, 2, 128, 64, torch.bfloat16, True, None, 0, 100),
            (1, 8, 2, 192, 128, torch.float32, True, 50, 0, 192),
            (1, 4, 4, 128, 64, torch.float32, False, None, 0, 77),
            (1, 4, 1, 64, 128, torch.bfloat16, True, 16, 64, 64),
            (1, 4, 2, 128, 64, torch.float32, True, 8, 0, 16)):  # masked rows
        q, k, v = (randn(B, h, S, d, dtype=dt), randn(B, kv, S, d, dtype=dt),
                   randn(B, kv, S, d, dtype=dt))
        kw = dict(causal=causal, window=win, q_offset=qoff, kv_len=kvl)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        name = "float32" if dt == torch.float32 else "bfloat16"
        check_close(f"flash B={B} H={h} KV={kv} S={S} hd={d} {name} "
                    f"causal={causal} window={win} q_offset={qoff} "
                    f"kv_len={kvl}", got, want, name)

    # timing at the largest prefill bucket the main path runs (2048)
    Sq = 2048
    q, k, v = randn(1, H, Sq, hd), randn(1, KV, Sq, hd), randn(1, KV, Sq, hd)
    flops = flash_flops(1, H, Sq, hd, Sq, 0, True, window)
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bound = max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["float32"]) * 1e3
    bound_by = ("bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_FLOPS["float32"]
                else "operations")
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=window))
    plain_ms = cuda_ms(lambda: flash_attention_plain(
        q, k, v, causal=True, window=window), iters=5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    log(f"  flash Sq=Skv={Sq} H={H} KV={KV} hd={hd} f32: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, bound {bound:.3f} ms "
        f"({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    out["flash_attention"] = dict(
        max_abs_err=flash_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, library_ms=lib_ms,
        shape=f"q [1,{H},{Sq},{hd}] f32, k/v [1,{KV},{Sq},{hd}], causal, "
              f"window {window}")

    # -- decode: full-width B=4, S=2048, f32 q, bf16 cache
    B, S = 4, 2048
    decode_err = 0.0
    for lens in ((1, 65, 2048, 1000), (64, 128, 2047, 2)):
        q = randn(B, H, hd)
        k = randn(B, S, KV, hd, dtype=torch.bfloat16)
        v = randn(B, S, KV, hd, dtype=torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = decode_attention(q, k, v, lengths)
        want = decode_attention_plain(q, k, v, lengths)
        decode_err = max(decode_err, check_close(
            f"decode qwen3-4b B={B} S={S} lengths={lens}", got, want,
            "float32"))
        # entries past each length must not reach the output at all
        pos = torch.arange(S, device=dev)[None, :, None, None]
        past = pos >= lengths[:, None, None, None]
        poisoned = decode_attention(q, torch.where(past, 3e4, k).to(k.dtype),
                                    torch.where(past, -3e4, v).to(v.dtype),
                                    lengths)
        if not torch.equal(poisoned, got):
            fail("decode kernel read cache entries past a length")
        log("  decode poisoned-past-length output identical: ok")
    for (b, h, kv, s, d, qdt, lens) in (
            (3, 4, 2, 100, 64, torch.float32, (1, 63, 100)),
            (2, 8, 1, 300, 128, torch.bfloat16, (257, 64))):
        q = randn(b, h, d, dtype=qdt)
        k = randn(b, s, kv, d, dtype=torch.bfloat16)
        v = randn(b, s, kv, d, dtype=torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        name = "float32" if qdt == torch.float32 else "bfloat16"
        check_close(f"decode B={b} H={h} KV={kv} S={s} hd={d} q {name} "
                    f"lengths={lens}", decode_attention(q, k, v, lengths),
                    decode_attention_plain(q, k, v, lengths), name)

    # the wrappers refuse what their kernels do not take, before a launch
    n0 = (flash_attention.launches, decode_attention.launches)
    for what, bad in (
            ("decode f32 cache", lambda: decode_attention(
                q, k.float(), v.float(), lengths)),
            ("decode int64 lengths", lambda: decode_attention(
                q, k, v, lengths.long())),
            ("flash mixed dtypes", lambda: flash_attention(
                randn(1, 4, 64, 64), randn(1, 2, 64, 64, dtype=torch.bfloat16),
                randn(1, 2, 64, 64, dtype=torch.bfloat16))),
            ("flash Sq not a multiple of 64", lambda: flash_attention(
                randn(1, 4, 48, 64), randn(1, 2, 48, 64), randn(1, 2, 48, 64)))):
        try:
            bad()
        except ValueError:
            continue
        fail(f"the wrapper took an input its kernel does not: {what}")
    if (flash_attention.launches, decode_attention.launches) != n0:
        fail("a refused input was counted as a launch")
    log("  wrappers refuse wrong dtypes and shapes with ValueError: ok")

    # timing at the full context of the main path's cache (every slot 2048)
    q = randn(B, H, hd)
    k = randn(B, S, KV, hd, dtype=torch.bfloat16)
    v = randn(B, S, KV, hd, dtype=torch.bfloat16)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    ctx = int(lengths.sum())
    nbytes = (4 * q.numel() * 2 + 2 * 2 * ctx * KV * hd + 4 * B)
    flops = 4 * ctx * H * hd
    bound = max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["float32"]) * 1e3
    bound_by = ("bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_FLOPS["float32"]
                else "operations")
    ms = cuda_ms(lambda: decode_attention(q, k, v, lengths), iters=50)
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, k, v, lengths))
    # one library call needs one dtype: SDPA on f32 copies of the cache
    kf = k.float().transpose(1, 2).contiguous()
    vf = v.float().transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[
        :, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kf, vf, attn_mask=mask, enable_gqa=True), iters=50)
    log(f"  decode B={B} S={S} ctx={ctx} H={H} KV={KV} hd={hd}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa(f32 cache) "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
        f"{nbytes / 1e6:.1f} MB)")
    out["decode_attention"] = dict(
        max_abs_err=decode_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, library_ms=lib_ms,
        shape=f"q [{B},{H},{hd}] f32, k/v [{B},{S},{KV},{hd}] bf16, "
              f"lengths {S} each")
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def _text(n: int, seed: int) -> str:
    import numpy as np
    rng = np.random.default_rng(seed)
    return "".join(chr(c) for c in rng.integers(97, 123, size=n))


def check_small_reference():
    """The reduced model on the GPU (kernels) against the same weights on
    the CPU (the kernels' plain versions): greedy tokens identical and
    prefill logits close."""
    import torch
    from repro_torch.core.assets import EXCHANGE

    log("  small-input reference: reduced qwen3-4b, GPU kernels vs CPU "
        "plain versions")
    # max_seq 48 < the reduced 64-token window: a linear cache, so decode
    # runs the decode kernel (a cache exactly one window long is a ring)
    gpu = EXCHANGE.get("qwen3-4b").build(smoke=True, max_seq=48,
                                         max_batch=3, device="cuda", seed=1)
    cpu = EXCHANGE.get("qwen3-4b").build(smoke=True, max_seq=48,
                                         max_batch=3, device="cpu",
                                         params=_to_numpy(gpu.params))
    prompts = [[256] + list(range(1, 1 + n)) for n in (3, 17, 24)]
    got = gpu.engine.generate(prompts, max_new_tokens=16)
    want = cpu.engine.generate(prompts, max_new_tokens=16)
    if [r.tokens for r in got] != [r.tokens for r in want]:
        fail("reduced model: GPU greedy tokens differ from the CPU "
             "reference")
    toks = torch.tensor([prompts[1]])
    lg, _ = gpu.model.prefill(gpu.params, {"tokens": toks.cuda()})
    lc, _ = cpu.model.prefill(cpu.params, {"tokens": toks})
    err = (lg.cpu() - lc).abs().max().item()
    if not torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4):
        fail(f"reduced model: prefill logits differ by {err:.3e}")
    log(f"    3 prompts x 16 greedy tokens identical; prefill logits "
        f"max_abs_err {err:.3e} (tolerance atol 1e-4 rtol 1e-4)")


def _to_numpy(params):
    if isinstance(params, dict):
        return {k: _to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def phase_main_path(cfg):
    import numpy as np
    import torch
    from repro_torch.core.assets import EXCHANGE
    from repro_torch.core.service import BatchedService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    log("== phase 3: main path")
    check_small_reference()

    t0 = time.perf_counter()
    wrapper = EXCHANGE.get("qwen3-4b").build(
        smoke=False, max_seq=2048, max_batch=4, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(wrapper.params))
    log(f"  built full-width {wrapper.cfg.name}: {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {n_params / 1e9:.2f} B f32 parameters, "
        f"in {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    eng = wrapper.engine

    # no host sync inside a decode chunk: one chunk under sync-debug "error"
    eng.insert_request([256] + list(range(65, 65 + 40)), 0)
    eng.insert_request([256] + list(range(65, 65 + 9)), 1)
    torch.cuda.synchronize()
    gen = torch.Generator(device="cuda").manual_seed(0)
    temps = np.asarray([0.0, 0.8, 0.0, 0.0], np.float32)
    budgets = np.asarray([8, 8, 0, 0], np.int32)
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emitted = eng.step_chunk(gen, temps, budgets, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if toks.shape != (4, 8) or not bool(emitted[:2].all()):
        fail("sync-free decode chunk returned a wrong block")
    log("  one 8-step decode chunk ran under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync inside")
    eng.reset()

    svc = BatchedService(wrapper, batch_window_s=0.05)
    greedy_new = 48
    inputs = [{"text": _text(n, i), "max_new_tokens": greedy_new}
              for i, n in enumerate((4, 60, 300, 1500))]
    inputs.append({"text": _text(30, 9), "max_new_tokens": 24,
                   "temperature": 0.8})
    outs = [None] * len(inputs)
    gate = threading.Barrier(len(inputs))

    def go(i):
        gate.wait(timeout=60)
        outs[i] = svc.predict(inputs[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(inputs))]
    steps0 = eng.steps_dispatched
    prefills0 = svc.scheduler.stats.prefills
    flash_attention.launches = 0
    decode_attention.launches = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    steps = eng.steps_dispatched - steps0
    prefills = svc.scheduler.stats.prefills - prefills0
    stats = svc.stats()
    svc.close()
    if any(t.is_alive() for t in threads):
        fail("a request did not return")

    for inp, env in zip(inputs, outs):
        if env is None or env.get("status") != "ok":
            fail(f"request failed: {env}")
        pred = env["predictions"][0]
        n = pred["generated_tokens"]
        if not 1 <= n <= inp["max_new_tokens"]:
            fail(f"request returned {n} tokens for max_new_tokens "
                 f"{inp['max_new_tokens']}")
        log(f"  request prompt {pred['prompt_tokens']:4d} tokens, "
            f"temperature {inp.get('temperature', 0.0)}: {n} tokens, "
            f"latency {env['latency_ms']:.1f} ms")
    for name, n in launches.items():
        if n <= 0:
            fail(f"the main path never launched the {name} kernel")
    if stats["max_batch_seen"] < 2:
        fail(f"no decode batch was shared: {stats['max_batch_seen']}")
    if prefills != len(inputs) or launches["flash_attention"] < prefills:
        fail(f"flash launches {launches['flash_attention']} for {prefills} "
             "prefills")
    if launches["flash_attention"] != cfg.num_layers * prefills:
        fail(f"flash launches {launches['flash_attention']} != "
             f"{cfg.num_layers} x {prefills} prefills")
    if launches["decode_attention"] != cfg.num_layers * steps:
        fail(f"decode launches {launches['decode_attention']} != "
             f"{cfg.num_layers} x {steps} decode steps")
    gen_tokens = sum(e["predictions"][0]["generated_tokens"] for e in outs)
    log(f"  {len(inputs)} concurrent requests, {gen_tokens} tokens in "
        f"{wall:.2f} s ({gen_tokens / wall:.1f} tokens/s end to end); "
        f"scheduler {stats['tokens_per_s']} tokens/s, mean batch "
        f"{stats['mean_batch_size']}, max batch {stats['max_batch_seen']}; "
        f"TTFT p50 {stats['ttft']['p50_ms']} ms, max "
        f"{stats['ttft']['max_ms']} ms")
    log(f"  launches: flash {launches['flash_attention']} "
        f"({prefills} prefills x {cfg.num_layers} layers), decode "
        f"{launches['decode_attention']} ({steps} decode steps x "
        f"{cfg.num_layers} layers)")

    # greedy outputs are independent of the co-batch: each greedy request
    # alone through engine.generate (one token per host read) agrees
    for inp, env in zip(inputs[:2], outs[:2]):
        x = wrapper._pre_process(inp)
        alone = eng.generate([x["tokens"]], max_new_tokens=greedy_new)[0]
        text = wrapper.format_generation(alone.tokens, len(x["tokens"]))
        if text != env["predictions"]:
            fail("co-batched greedy output differs from the same request "
                 "alone")
    log("  co-batched greedy outputs equal the same requests run alone")
    profile_decode(eng)
    return launches


def profile_decode(eng):
    """Where a decode step's time goes: one 8-step chunk at B=4 timed on
    the host clock, then traced with torch.profiler (device busy time and
    the kernels that fill it). Launches here are outside the main-path
    count above."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import _bucket

    eng.reset()
    lens = (100, 500, 1000, 1500)
    for slot, n in enumerate(lens):
        t0 = time.perf_counter()
        eng.insert_request([256] + [97 + i % 26 for i in range(n - 1)], slot)
        torch.cuda.synchronize()
        log(f"  prefill of {n} tokens (bucket {_bucket(n)}): "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    gen = torch.Generator(device="cuda").manual_seed(0)
    temps = np.zeros((eng.max_batch,), np.float32)
    budgets = np.full((eng.max_batch,), 64, np.int32)
    eng.step_chunk(gen, temps, budgets, 8)               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_chunk(gen, temps, budgets, 8)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step_chunk(gen, temps, budgets, 8)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's row also carries the device
    # time of the kernels it launched, which would count twice
    rows = [(evt.self_device_time_total, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    busy = sum(r[0] for r in rows) / 1e3 / 8
    n_kernels = sum(r[1] for r in rows) / 8
    log(f"  decode step at B=4, contexts {lens}: {wall:.2f} ms wall, "
        f"{busy:.2f} ms device busy ({100 * (1 - busy / wall):.0f}% idle), "
        f"{n_kernels:.0f} kernels per step (host clock; torch.profiler)")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev_us / 1e3 / 8:7.3f} ms/step  {count // 8:5d}/step  "
            f"{key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-4b")
    card = phase_build()
    kernels = phase_kernels(cfg)
    launches = phase_main_path(cfg)

    sources = {"flash_attention": ("src/repro/kernels/flash_attention.py:76"),
               "decode_attention": ("src/repro/kernels/decode_attention.py:195")}
    line = []
    for name, replaces in sources.items():
        k = kernels[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "timed_at": k["shape"]})
    log("== phase 4: kernels")
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
