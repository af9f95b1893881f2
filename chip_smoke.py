"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, started together) and print the card's name and power
   limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's full-width shapes and at small ones, then sweep both decode
   kernels over every split count (1-32 blocks per sequence and KV head)
   with a cold and a warm L2, failing if ``decode_splits``' pick is more
   than 25% slower than the best (2b: the recurrent kernels and flash at
   head_dim 256, at the hybrid's and the SSM's full-width prefill shapes,
   ``rglru_scan`` also at its segment and round edges, three draws of a,
   an Inf case and ragged W, timed at every prefill bucket the hybrid
   serves beside PyTorch's elementwise a + b;
   2c: ``gmm`` at every shape phase 8 can give it, a decode step's and
   each prefill bucket's, and at ragged ones, its tensor-core path above
   C = 16 no slower than ``torch.bmm``);
3. drive the contiguous path: full-width ``qwen3-4b`` (random weights from
   a seed) built through the exchange on ``cuda`` and served by
   ``BatchedService`` to concurrent greedy requests and one sampled one;
   check every result, the batch sharing, the kernels' launch counts, and
   that a decode chunk makes no host sync;
4. drive the HTTP path: the port's ``MAXServer`` deploys the same model
   with ``{"paged": true}`` and serves the same greedy requests as v2
   predicts (tokens equal the contiguous ones), then redeploys with
   ``{"paged": true, "prefix_cache": true}`` and serves four greedy
   requests sharing a 1,023-character prefix plus a sampled one, and a
   warm replay (tokens equal its first run); check the paged kernel ran on
   every decode and fill step, the linear one never, and that no pool page
   leaks;
4c. the request lifecycle on the same server: redeploy with a QoS config
   and stream phase 3's four greedy requests at once (ids equal the
   contiguous engine's, ``id`` rising by 1, one ``done``), a job read in
   part, dropped and resumed with ``Last-Event-ID``, a stream of a
   1,000-token prompt dropped after its first token (cancelled, idle
   within two chunks, no page leak), ``DELETE`` on a running job, an
   interactive job admitted before queued best_effort ones (from the
   traces), a 504 on an unmeetable deadline, a 429 with ``Retry-After``,
   ``/v2/metrics`` in Prometheus text, a job's trace and the Chrome
   export, then the sync service on the contiguous layout; hold each
   dense kernel's launches to its steps or prefills, and the scheduler's
   host reads to one for each tick that ran a chunk (the ticks from the
   trace's tick lane; the worker's reads and synchronizing operations
   counted on the card, none on any other thread);
4d. the robustness half on the same server, after the JAX chaos scenario
   (``benchmarks/run.py::bench_robustness``): 16 greedy requests of 8
   tokens to a fault-free deployment, then to one with ~5% seeded
   per-chunk faults (every one completes with its twin's tokens);
   scripted admission and slot-2 chunk faults retire only their victims;
   a stream faulted after its first token ends in an ``error`` event; a
   kill at tick 0 is respawned by the watchdog, the new worker recovers
   (quarantine, reset) and the jobs finish with phase 3's tokens, with
   4c.h's count of reads and synchronizing operations (none off the
   worker); three faults in a row rebuild the engine and
   ``memory_allocated`` returns to its level within one page; HARD
   brownout turns ``/v2/health`` 503 with ``Retry-After`` and predicts
   ``CIRCUIT_OPEN``, SOFT sheds best_effort and clamps, released it reads
   200;
5. and 6. the recurrent families, one on the card at a time: deploy
   full-width ``recurrentgemma-9b`` (hybrid), then ``rwkv6-7b`` (SSM), over
   HTTP at ``max_batch`` 4 and ``max_seq`` 4096; serve four greedy v2
   predicts (5-1501 tokens) and one v1 predict sampled at 0.8 at once;
   check the launches (per prefill: 26 ``rglru_scan`` + 12 flash, or 32
   ``wkv_scan``; none in decode; ``rglru_scan``'s by shape), co-batched ==
   alone, every greedy token against the scoring forward's argmax, and the
   reduced model GPU == CPU;
   profile a decode step; print the peak memory; undeploy;
8. the MoE family: reduced Phi-3.5-MoE and Qwen3-MoE GPU == CPU, then
   full-width Phi-3.5-MoE cut to 8 of its 32 layers (42.7 GB of f32
   weights) deployed over HTTP with ``{"paged": true, "prefix_cache":
   true}``; the same traffic as 5-6, then each greedy request alone (a
   warm replay); check 3 ``gmm`` per layer per prefill and per decode or
   fill step, each at a shape 2c checked, co-batched == alone, the pool,
   and print the assignments each served prefill dropped (capacity; from
   a replay of the prefill, outside the timed traffic); greedy tokens
   against a dropless scoring forward where no real token's assignment
   dropped; profile a decode step; undeploy;
7. then print ``{"kernels": [...]}`` with each kernel's launches on its
   path, its error against the plain version, and its time, the plain
   version's time, the bound and a library call's time, all measured
   here; and ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX and nothing of the JAX package. Without a GPU,
or without the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device
# memory bandwidth, and f32 (CUDA cores) / TF32 and bf16 (tensor cores)
# rates.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
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

def cuda_ms(fn, iters: int = 20, warmup: int = 3, cold: bool = True) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, each timed by its
    own CUDA events, by default with a cold L2: a 256 MB buffer is
    rewritten before each call (untimed), as the main path's weight stream
    evicts a layer's inputs between its launches (``cold=False``: back to
    back, the inputs left in L2 by the call before). A spin kernel first
    holds the device while the host queues every call, so host time does
    not show."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(2_000_000 * iters)       # ~1 ms per call at ~2 GHz
    for s, e in zip(starts, ends):
        if cold:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def ttft_text(stats) -> str:
    """The TTFT histogram of a service's stats (seconds, recent-window
    percentiles) as one log phrase."""
    t = stats["ttft"]
    return (f"TTFT p50 {t['p50'] * 1e3:.1f} ms, p95 {t['p95'] * 1e3:.1f} ms "
            f"({t['count']} requests)")


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


def bound_ms(nbytes, flops, peak=PEAK_FLOPS["float32"]):
    """(bound ms, "bytes" | "operations"): the least time on the H100's
    published peaks (memory rate; the f32 rate, or ``peak``) for the bytes
    and operations a call needs."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def flash_bound_ms(nbytes, flops):
    """(bound ms, "bytes" | "operations", the CUDA-core bound ms) of flash
    attention: the least time of either route to an f32-accurate product,
    3xTF32 on the tensor cores (three TF32 products per f32 one at 495
    TFLOP/s, the kernel's route) or the CUDA cores at 67 TFLOP/s, against
    the bytes at the memory rate. The bound on the CUDA cores alone is
    kept beside it."""
    bound, bound_by = min(bound_ms(nbytes, 3 * flops, PEAK_FLOPS["tf32"]),
                          bound_ms(nbytes, flops))
    return bound, bound_by, bound_ms(nbytes, flops)[0]


def kernel_times(fn, calls):
    """[(kernel name, device ms per call)] of ``fn()`` over ``calls``
    calls back to back, from torch.profiler's device-side events; empty
    when the profiler reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(evt.key.replace("(anonymous namespace)::", "")
             .removeprefix("void ").split("(")[0],
             evt.self_device_time_total / calls / 1e3)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]


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

    # full width, Sq != Skv: a 512-row query block at offset 1,536 of a
    # 2,048-key cache whose last 48 columns are padding
    q, k, v = randn(1, H, 512, hd), randn(1, KV, 2048, hd), \
        randn(1, KV, 2048, hd)
    kw = dict(causal=True, window=window, q_offset=1536, kv_len=2000)
    flash_err = max(flash_err, check_close(
        "flash qwen3-4b Sq=512 Skv=2048 q_offset=1536 kv_len=2000 f32",
        flash_attention(q, k, v, **kw), flash_attention_plain(q, k, v, **kw),
        "float32"))

    # timing at the largest prefill bucket the main path runs (2048)
    Sq = 2048
    q, k, v = randn(1, H, Sq, hd), randn(1, KV, Sq, hd), randn(1, KV, Sq, hd)
    flops = flash_flops(1, H, Sq, hd, Sq, 0, True, window)
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bound, bound_by, simt = flash_bound_ms(nbytes, flops)
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=window))
    plain_ms = cuda_ms(lambda: flash_attention_plain(
        q, k, v, causal=True, window=window), iters=5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    log(f"  flash Sq=Skv={Sq} H={H} KV={KV} hd={hd} f32: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} "
        f"ms ({bound_by}; {flops / 1e9:.1f} GFLOP x3 in TF32 at 495 "
        f"TFLOP/s, {nbytes / 1e6:.1f} MB), CUDA-core bound {simt:.4f} ms")
    out["flash_attention"] = dict(
        max_abs_err=flash_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, simt_bound_ms=simt, library_ms=lib_ms,
        library="torch.nn.functional.scaled_dot_product_attention",
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
    # group sizes 1-8 (the kernel gives each pair of warps a head, or two
    # above 4: G = 1 and 3 leave warps idle, 6 pads a head)
    for (b, h, kv, s, d, qdt, lens) in (
            (3, 4, 2, 100, 64, torch.float32, (1, 63, 100)),
            (2, 8, 1, 300, 128, torch.bfloat16, (257, 64)),
            (2, 2, 2, 96, 128, torch.float32, (96, 50)),
            (2, 3, 1, 100, 128, torch.float32, (37, 100)),
            (2, 6, 1, 200, 64, torch.bfloat16, (1, 200))):
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
    bound, bound_by = bound_ms(nbytes, flops)
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
        library="scaled_dot_product_attention on an f32 copy of the cache",
        shape=f"q [{B},{H},{hd}] f32, k/v [{B},{S},{KV},{hd}] bf16, "
              f"lengths {S} each")
    out["paged_decode_attention"] = check_paged(cfg, randn)
    splits = sweep_decode_splits(cfg, randn)
    for name in ("decode_attention", "paged_decode_attention"):
        out[name]["split"] = splits["paged" if name.startswith("paged")
                                    else "contiguous"]
    return out


def paged_inputs(randn, B, H, KV, hd, N, P, nb, lens, qdtype=None):
    """q, pools [N, P, KV, hd] bf16 and a shuffled block table with
    sentinel N past each length; every page no sequence owns, and every
    row past a length, poisoned."""
    import torch
    dev = torch.device("cuda")
    q = randn(B, H, hd, dtype=qdtype or torch.float32)
    kp = randn(N, P, KV, hd, dtype=torch.bfloat16)
    vp = randn(N, P, KV, hd, dtype=torch.bfloat16)
    perm = torch.randperm(N, device="cpu",
                          generator=torch.Generator().manual_seed(N + P))
    table = torch.full((B, nb), N, dtype=torch.int32)
    owned = torch.zeros((N, P), dtype=torch.bool)
    taken = 0
    for b, ln in enumerate(lens):
        for i in range(-(-ln // P)):
            table[b, i] = int(perm[taken])
            taken += 1
        for t in range(ln):
            owned[int(table[b, t // P]), t % P] = True
    owned = owned.to(dev)[:, :, None, None]
    kp = torch.where(owned, kp, 3e4).to(torch.bfloat16)
    vp = torch.where(owned, vp, -3e4).to(torch.bfloat16)
    return (q, kp, vp, table.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def check_paged(cfg, randn):
    """The paged kernel against its plain version: full-width shapes of
    the HTTP path (B=4, pool 512 x 16 x 8 x 128 bf16, f32 q, contexts up
    to 2048, shuffled table with sentinels, poisoned pages), then pages
    smaller than, equal to and larger than the 64-row tile; then refusals
    and timing (cold L2)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, N, P, nb = 4, 512, 16, 2048 // 16
    err = 0.0
    for lens in ((1, 16, 17, 2048), (0, 1000, 2047, 64)):
        args = paged_inputs(randn, B, H, KV, hd, N, P, nb, lens)
        got = paged_decode_attention(*args)
        want = paged_decode_attention_plain(*args)
        err = max(err, check_close(
            f"paged qwen3-4b B={B} pool {N}x{P} lengths={lens}", got, want,
            "float32"))
        if not torch.isfinite(got).all():
            fail("paged kernel output is not finite")
        for b, ln in enumerate(lens):
            if ln == 0 and got[b].abs().max().item() != 0:
                fail("paged kernel: a length of 0 did not write zeros")
        # the same inputs with every unowned page and row set to NaN: a
        # single such row read would turn the output NaN
        q, kp, vp, table, lengths = args
        pos = torch.arange(P, device=q.device)
        owned = torch.zeros((N, P), dtype=torch.bool, device=q.device)
        for b, ln in enumerate(lens):
            pages = table[b, :-(-ln // P)].long()
            owned[pages] = True
            if ln % P:
                owned[table[b, ln // P].long()] = pos < ln % P
        nan = torch.tensor(float("nan"), dtype=torch.bfloat16,
                           device=q.device)
        keep = owned[:, :, None, None]
        poisoned = paged_decode_attention(q, torch.where(keep, kp, nan),
                                          torch.where(keep, vp, nan), table,
                                          lengths)
        if not torch.equal(poisoned, got):
            fail("paged kernel read a pool row it does not own")
    log("  paged: with every unowned page and every row past a length "
        "set to NaN the output is bit-identical; length 0 gave zeros: ok")
    for (b, h, kv, d, n, p, nblk, qdt, lens) in (
            (3, 8, 2, 128, 40, 8, 16, torch.float32, (1, 65, 128)),
            (2, 4, 1, 64, 9, 64, 3, torch.bfloat16, (64, 130)),
            (2, 8, 2, 128, 6, 128, 2, torch.float32, (129, 256)),
            (3, 4, 2, 64, 30, 5, 12, torch.float32, (0, 5, 59)),
            (2, 6, 1, 128, 20, 16, 8, torch.float32, (0, 100)),
            (3, 3, 3, 64, 12, 8, 4, torch.bfloat16, (31, 1, 17))):
        args = paged_inputs(randn, b, h, kv, d, n, p, nblk, lens, qdt)
        name = "float32" if qdt == torch.float32 else "bfloat16"
        check_close(f"paged B={b} H={h} KV={kv} hd={d} pool {n}x{p} "
                    f"nb={nblk} q {name} lengths={lens}",
                    paged_decode_attention(*args),
                    paged_decode_attention_plain(*args), name)

    q, kp, vp, table, lengths = paged_inputs(randn, B, H, KV, hd, N, P, nb,
                                             (2048,) * B)
    n0 = paged_decode_attention.launches
    for what, bad in (
            ("f32 pool", lambda: paged_decode_attention(
                q, kp.float(), vp.float(), table, lengths)),
            ("int64 table", lambda: paged_decode_attention(
                q, kp, vp, table.long(), lengths)),
            ("table on the CPU", lambda: paged_decode_attention(
                q, kp, vp, table.cpu(), lengths))):
        try:
            bad()
        except ValueError:
            continue
        fail(f"the paged wrapper took an input its kernel does not: {what}")
    if paged_decode_attention.launches != n0:
        fail("a refused input was counted as a launch")
    log("  paged wrapper refuses wrong dtypes and devices: ok")

    ctx = int(lengths.sum())
    nbytes = (4 * q.numel() * 2 + 2 * 2 * ctx * KV * hd
              + 4 * table.numel() + 4 * B)
    flops = 4 * ctx * H * hd
    bound, bound_by = bound_ms(nbytes, flops)
    ms = cuda_ms(lambda: paged_decode_attention(q, kp, vp, table, lengths),
                 iters=50)
    plain_ms = cuda_ms(lambda: paged_decode_attention_plain(
        q, kp, vp, table, lengths))
    # the library route: gather the pages (k_pool[block_table]), then one
    # scaled_dot_product_attention; one dtype, so from f32 copies of the
    # pools made outside the timed calls
    kpf, vpf = kp.float(), vp.float()
    bt = table.long().clamp(0, N - 1)
    mask = (torch.arange(nb * P, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]

    def library():
        k = kpf[bt].reshape(B, nb * P, KV, hd).transpose(1, 2)
        v = vpf[bt].reshape(B, nb * P, KV, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask, enable_gqa=True)

    lib_ms = cuda_ms(library, iters=50)
    log(f"  paged B={B} pool {N}x{P}x{KV}x{hd} ctx={ctx}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, gather + sdpa (f32 pool copy) "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
        f"{nbytes / 1e6:.1f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=lib_ms,
                library="k_pool[block_table] gather + "
                        "scaled_dot_product_attention",
                shape=f"q [{B},{H},{hd}] f32, pools [{N},{P},{KV},{hd}] bf16, "
                      f"shuffled table [{B},{nb}], lengths 2048 each")


# the split decode_splits picks may be at most this much slower than the
# best one the sweep finds, at the main path's shape
SPLIT_SLACK = 1.25


def sweep_decode_splits(cfg, randn):
    """Both decode kernels at every split count the grid allows (1 to 32
    blocks per (b, kv_head)), at B=4 over the HTTP path's pool with lengths
    2048 each and with the served contexts (100, 500, 1000, 1500), each
    checked against the plain version and timed with a cold and a warm L2;
    fails if, at lengths 2048 and a cold L2, the split ``decode_splits``
    picks is more than 25% slower than the best one. Calls the wrappers'
    launch helpers at each split (the wrappers pick their own), so no
    launch here is counted."""
    import torch
    from repro_torch.kernels import decode_attention as da

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, N, P, nb = 4, 512, 16, 2048 // 16
    S = nb * P
    dev = torch.device("cuda")
    chosen = da.decode_splits(
        B, KV, S, torch.cuda.get_device_properties(dev).multi_processor_count)
    tiles = -(-S // da.TILE)
    pers = sorted({-(-tiles // n) for n in range(1, 33)}
                  | {chosen[0] // da.TILE}, reverse=True)
    kinds = ("paged", "contiguous")
    times = {}
    for lens in ((S,) * B, (100, 500, 1000, 1500)):
        q, kp, vp, table, lengths = paged_inputs(randn, B, H, KV, hd, N, P,
                                                 nb, lens)
        rows = table.long().clamp(0, N - 1)
        kc = kp[rows].reshape(B, S, KV, hd).contiguous()
        vc = vp[rows].reshape(B, S, KV, hd).contiguous()
        want = da.paged_decode_attention_plain(q, kp, vp, table, lengths)
        out = torch.empty_like(q)
        for per in pers:
            split_len, nsplit = per * da.TILE, -(-tiles // per)
            calls = {
                "paged": lambda: da._launch_paged(
                    q, kp, vp, table, lengths, out, split_len, nsplit),
                "contiguous": lambda: da._launch_contiguous(
                    q, kc, vc, lengths, out, split_len, nsplit)}
            line = []
            for name in kinds:
                call = calls[name]
                out.fill_(float("nan"))
                call()
                if not torch.allclose(out, want, **TOL["float32"]):
                    fail(f"{name} decode at split {split_len} x {nsplit}, "
                         f"lengths {lens}, disagrees with its plain version")
                cold = cuda_ms(call, iters=30)
                warm = cuda_ms(call, iters=30, cold=False)
                times[name, lens, nsplit] = cold
                line.append(f"{name} {cold:.4f} / {warm:.4f}")
            mark = "  <- decode_splits" if (split_len, nsplit) == chosen else ""
            log(f"  split sweep lengths={lens} nsplit={nsplit:2d} "
                f"split_len={split_len:4d}, ms cold / warm L2: "
                f"{' | '.join(line)}{mark}")
    best = {}
    for name in kinds:
        at = {n: t for (k, lens, n), t in times.items()
              if k == name and lens == (S,) * B}
        n_best = min(at, key=at.get)
        best[name] = dict(nsplit=chosen[1], best_nsplit=n_best,
                          ms=at[chosen[1]], best_ms=at[n_best])
        log(f"  {name} decode, lengths {S} x {B}, cold L2: decode_splits' "
            f"nsplit {chosen[1]} {at[chosen[1]]:.4f} ms, best nsplit "
            f"{n_best} {at[n_best]:.4f} ms")
        if at[chosen[1]] > SPLIT_SLACK * at[n_best]:
            fail(f"{name} decode: decode_splits' split is more than "
                 f"{SPLIT_SLACK - 1:.0%} slower than the best one swept")
    return best


def check_scaled(name, got, want, rel):
    """Max abs error against the plain version, held to ``rel`` times the
    plain output's largest magnitude (a recurrence accumulates rounding
    over its steps, so the error scales with the values)."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= rel * scale
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {rel:g} x max|plain| "
        f"= {rel * scale:.3e}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# the RG-LRU scan's timed shapes: [1, S, 4096] at each prefill bucket the
# hybrid serves (16 to its max_seq 4096), and B = 4
RGLRU_TIMED = tuple((1, S, 4096) for S in (16, 32, 64, 512, 2048, 4096)) \
    + ((4, 2048, 4096),)


def rglru_decays(uniform, shape, draw):
    """a for the RG-LRU checks: [0.5, 0.999] (the first version's draw),
    the model's range exp(-8 softplus(lam) r) for lam in its init span
    [0.3, 1.5] and r in (0, 1) (models/rglru.py::_gates), or [0, 1] with
    exact zeros and ones (a tenth each: the kernel's contract)."""
    import torch
    import torch.nn.functional as F
    if draw == "[0.5, 0.999]":
        return uniform(*shape, lo=0.5, hi=0.999)
    if draw == "model range":
        return torch.exp(-8.0 * F.softplus(uniform(*shape, lo=0.3, hi=1.5))
                         * uniform(*shape, lo=0.0, hi=1.0))
    a, pick = uniform(*shape, lo=0.0, hi=1.0), uniform(*shape, lo=0.0,
                                                        hi=1.0)
    return torch.where(pick < 0.1, 0.0, torch.where(pick > 0.9, 1.0, a))


def check_rglru(uniform):
    """``rglru_scan`` against its plain version (f32 atol 2e-5, rtol 2e-4,
    one recurrence) at S = 0 and 1, at each edge of the kernel's segment
    (K) and round (R = 32 K): K - 1, K, K + 1, R - 1, R, R + 1, and at
    1501, 2048 and 4096 (the hybrid's max_seq); B 1, 3 and 4; W 4096 with
    h0 and a ragged 1000 (not a multiple of 32 or 4) without; a from the
    three draws of ``rglru_decays``. Then an Inf case for each draw (+Inf,
    -Inf and NaN exactly where the plain version has them), and the kernel
    timed with a cold L2 at ``RGLRU_TIMED`` beside its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rglru import (ROUND, SEGMENT, rglru_scan,
                                           rglru_scan_plain)
    K, R = SEGMENT, ROUND
    shapes = ((1, 0), (3, 0), (1, 1), (4, K - 1), (1, K), (3, K + 1),
              (4, R - 1), (1, R), (3, R + 1), (1, 1501), (1, 2048),
              (4, 2048), (3, 4096))
    tol = TOL["float32"]
    err, cases = 0.0, 0
    for draw in ("[0.5, 0.999]", "model range", "[0, 1] with 0 and 1"):
        for B, S in shapes:
            for W, with_h0 in ((4096, True), (1000, False)):
                a = rglru_decays(uniform, (B, S, W), draw)
                b = uniform(B, S, W, lo=-0.2, hi=0.2)
                h0 = uniform(B, W, lo=-0.2, hi=0.2) if with_h0 else None
                h, last = ops.rglru_scan(a, b, h0)
                ph, plast = rglru_scan_plain(a, b, h0)
                name = (f"rglru_scan B={B} S={S} W={W} a {draw} h0 "
                        f"{'!= 0' if with_h0 else 'None'}")
                if h.shape != (B, S, W) or last.shape != (B, W):
                    fail(f"{name}: shapes {tuple(h.shape)}, "
                         f"{tuple(last.shape)}")
                if S == 0 and not torch.equal(last, plast):
                    fail(f"{name}: h_last is not h0")
                for got, want in ((h, ph), (last, plast)):
                    if got.numel() == 0:
                        continue
                    e = (got - want).abs().max().item()
                    if not torch.allclose(got, want, **tol):
                        fail(f"{name} disagrees with its plain version: "
                             f"max_abs_err {e:.3e} (atol {tol['atol']:g} "
                             f"rtol {tol['rtol']:g})")
                    err = max(err, e)
                cases += 1
        log(f"  rglru_scan, a {draw}: {len(shapes) * 2} cases (S 0 to "
            f"4096, B 1/3/4, W 4096 with h0 and 1000 without) within atol "
            f"{tol['atol']:g} rtol {tol['rtol']:g} of the plain version; "
            f"h_last == h0 at S = 0")
    log(f"  rglru_scan: {cases} cases, max_abs_err {err:.3e}")

    # an Inf in b: the state is infinite from there on (NaN where +Inf and
    # -Inf meet in one channel, or where an exact a = 0 meets Inf); in the
    # model's range, products of a over a round underflow to 0, where the
    # scan's pairs alone would give NaN for the steps' Inf
    B, S, W = 1, 2048, 4096
    for draw in ("[0.5, 0.999]", "model range", "[0, 1] with 0 and 1"):
        a = rglru_decays(uniform, (B, S, W), draw)
        b = uniform(B, S, W, lo=-0.2, hi=0.2)
        h0 = uniform(B, W, lo=-0.2, hi=0.2)
        for t, c, v in ((5, 0, float("inf")), (R + 9, 1, float("-inf")),
                        (17, 2, float("inf")), (R + 30, 2, float("-inf")),
                        (3 * R + K, 1000, float("inf")),
                        (S - 1, 4095, float("-inf"))):
            b[0, t, c] = v
        h, last = rglru_scan(a, b, h0)
        ph, plast = rglru_scan_plain(a, b, h0)
        for got, want in ((h, ph), (last, plast)):
            for cls in (torch.isposinf, torch.isneginf, torch.isnan):
                if not torch.equal(cls(got), cls(want)):
                    fail(f"rglru_scan with Inf in b, a {draw}: "
                         f"{cls.__name__} differs from the plain version's "
                         f"at {int((cls(got) != cls(want)).sum())} places")
            fin = torch.isfinite(want)
            if not torch.allclose(got[fin], want[fin], **tol):
                fail(f"rglru_scan with Inf in b, a {draw}: the finite "
                     "outputs disagree")
        log(f"  rglru_scan with +-Inf in b at 6 places, a {draw}: "
            f"{int(ph.isposinf().sum())} +Inf, {int(ph.isneginf().sum())} "
            f"-Inf, {int(ph.isnan().sum())} NaN, exactly where the plain "
            "version has them; finite elsewhere, within tolerance: ok")

    # times, cold L2, with h0; bytes: a, b, h read or written once, h0 and
    # h_last; one FMA a step and channel
    def bound(B, S, W):
        return bound_ms(4 * (3 * B * S * W + 2 * B * W), 2 * B * S * W)

    # beside each, PyTorch's elementwise a + b: the same bytes read and
    # written, no recurrence (a yardstick of the memory rate a streaming
    # kernel reaches, not a library call for this function)
    by_shape = []
    for B, S, W in RGLRU_TIMED:
        a = uniform(B, S, W, lo=0.5, hi=0.999)
        b = uniform(B, S, W, lo=-0.2, hi=0.2)
        h0 = uniform(B, W, lo=-0.2, hi=0.2)
        ms = cuda_ms(lambda: rglru_scan(a, b, h0))
        h = torch.empty_like(a)
        add_ms = cuda_ms(lambda: torch.add(a, b, out=h))
        bnd, bound_by = bound(B, S, W)
        by_shape.append(dict(shape=[B, S, W], ms=ms, bound_ms=bnd,
                             bound_by=bound_by, elementwise_ms=add_ms))
        log(f"  rglru_scan [{B},{S},{W}] f32, cold L2: kernel {ms:.4f} ms, "
            f"bound {bnd:.4f} ms ({bound_by}; {bnd / ms:.0%} of it), "
            f"elementwise a + b {add_ms:.4f} ms")

    B, S, W = 1, 2048, 4096
    a = uniform(B, S, W, lo=0.5, hi=0.999)
    b = uniform(B, S, W, lo=-0.2, hi=0.2)
    h0 = uniform(B, W, lo=-0.2, hi=0.2)
    main = by_shape[RGLRU_TIMED.index((B, S, W))]
    plain_ms = cuda_ms(lambda: rglru_scan_plain(a, b, h0), iters=3)
    log("  rglru_scan launch, device ms per call (torch.profiler, 5 calls "
        "back to back): " + ", ".join(
            f"{name} {t:.4f}" for name, t in
            kernel_times(lambda: rglru_scan(a, b, h0), 5)))
    log(f"  rglru_scan [{B},{S},{W}] f32: kernel {main['ms']:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {main['bound_ms']:.4f} ms "
        f"({main['bound_by']}); no single PyTorch call computes the "
        "recurrence")
    return dict(
        max_abs_err=err, ms=main["ms"], plain_ms=plain_ms,
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None,
        library="none: no single PyTorch call computes the recurrence",
        shape=f"a/b [{B},{S},{W}] f32, h0 [{B},{W}]", by_shape=by_shape)


def phase_recurrent_kernels():
    """The hybrid's and the SSM's kernels against their plain versions at
    the shapes their full-width prefills give them (a 2048-token bucket:
    W = lru_width 4096; 64 heads of 64; 16 query heads on one KV head at
    hd 256 with the 2048-token local window), a ragged length, and B = 4;
    then each timed with a cold L2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.kernels.rwkv6 import wkv_scan, wkv_scan_plain

    log("== phase 2b: recurrent kernels and flash at hd 256 vs plain "
        "versions")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def uniform(*shape, lo, hi):
        return lo + (hi - lo) * torch.rand(*shape, device=dev, generator=gen)

    out = {}
    out["rglru_scan"] = check_rglru(uniform)
    # -- wkv_scan: up to 2,048 steps of state accumulation, compared
    #    relative to the output's scale: f32 rounding (2^-24) over the steps
    #    and the 64-term sums stays far below 1e-4 of the largest value. T
    #    at and around the kernel's chunk edges (CHUNK = 64: 1, 33, 64, 65,
    #    1501, 2048), w from three draws: the first version's [0.9, 0.999],
    #    the model's range exp(-exp(d)) for d in [-12, 1.5]
    #    (models/rwkv6.py), and [0, 1] with exact zeros and ones (a tenth
    #    each: the kernel's contract)
    H, N, rel = 64, 64, 1e-4

    def decays(B, T, draw):
        if draw == "[0.9, 0.999]":
            return uniform(B, T, H, N, lo=0.9, hi=0.999)
        if draw == "model range":
            return torch.exp(-torch.exp(uniform(B, T, H, N, lo=-12.0,
                                                hi=1.5)))
        w = uniform(B, T, H, N, lo=0.0, hi=1.0)
        pick = uniform(B, T, H, N, lo=0.0, hi=1.0)
        return torch.where(pick < 0.1, 0.0, torch.where(pick > 0.9, 1.0, w))

    wkv_err = 0.0
    for draw in ("[0.9, 0.999]", "model range", "[0, 1] with 0 and 1"):
        for B, T in ((1, 2048), (1, 1501), (2, 33), (1, 1), (1, 64),
                     (2, 65)):
            r, k, v = randn(B, T, H, N), randn(B, T, H, N, scale=0.2), \
                randn(B, T, H, N)
            w = decays(B, T, draw)
            u = randn(H, N)
            s0 = randn(B, H, N, N, scale=0.1)
            for with_s0 in (True, False):
                y, s = ops.wkv_scan(r, k, v, w, u, s0 if with_s0 else None)
                py, ps = wkv_scan_plain(r, k, v, w, u,
                                        s0 if with_s0 else None)
                name = (f"wkv_scan B={B} T={T} H={H} N={N} w {draw} "
                        f"s0 {'!= 0' if with_s0 else 'None'}")
                wkv_err = max(wkv_err, check_scaled(f"{name} y", y, py, rel),
                              check_scaled(f"{name} s_final", s, ps, rel))
    B, T = 1, 2048
    r, k, v = randn(B, T, H, N), randn(B, T, H, N, scale=0.2), \
        randn(B, T, H, N)
    w = uniform(B, T, H, N, lo=0.9, hi=0.999)
    u, s0 = randn(H, N), randn(B, H, N, N, scale=0.1)
    # bytes: r, k, v, w, y, u and both states; operations: y_j =
    # sum_i r_i S_ij (2 N^2) plus v_j (r.u.k) (O(N)), S_ij = w_i S_ij +
    # k_i v_j (3 N^2), per step and head
    bound, bound_by = bound_ms(4 * (5 * B * T * H * N + H * N + 2 * B * H * N * N),
                             5 * N * N * B * T * H)
    ms = cuda_ms(lambda: wkv_scan(r, k, v, w, u, s0))
    plain_ms = cuda_ms(lambda: wkv_scan_plain(r, k, v, w, u, s0), iters=3)
    log(f"  wkv_scan [{B},{T},{H},{N}] f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}); no single "
        "PyTorch call computes the recurrence")
    # the chunked scan is three launches: each one's device time
    log("  wkv_scan launches, device ms per call (torch.profiler, 5 calls "
        "back to back): " + ", ".join(
            f"{name} {t:.4f}" for name, t in
            kernel_times(lambda: wkv_scan(r, k, v, w, u, s0), 5)))
    out["wkv_scan"] = dict(
        max_abs_err=wkv_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, library_ms=None,
        library="none: no single PyTorch call computes the recurrence",
        shape=f"r/k/v/w [{B},{T},{H},{N}] f32, u [{H},{N}], s0 "
              f"[{B},{H},{N},{N}]")

    # -- flash at hd 256: MQA (16 query heads, one KV head), causal, the
    #    2048-token local window (= causal at S <= 2048) and a 512 window
    Hq, KV, hd = 16, 1, 256
    fl_err = 0.0
    for S, window in ((2048, 2048), (2048, 512), (1501, 2048), (16, 2048)):
        q, k, v = randn(1, Hq, S, hd), randn(1, KV, S, hd), randn(1, KV, S, hd)
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        fl_err = max(fl_err, check_close(
            f"flash hd=256 H={Hq} KV={KV} S={S} window={window} f32", got,
            want, "float32"))
    q, k, v = (randn(2, 4, 128, hd).to(torch.bfloat16),
               randn(2, 2, 128, hd).to(torch.bfloat16),
               randn(2, 2, 128, hd).to(torch.bfloat16))
    check_close("flash hd=256 B=2 H=4 KV=2 S=128 bf16 window 40",
                flash_attention(q, k, v, causal=True, window=40),
                flash_attention_plain(q, k, v, causal=True, window=40),
                "bfloat16")

    # refusals before any launch
    n0 = (rglru_scan.launches, wkv_scan.launches)
    a, b, h0 = uniform(1, 16, 64, lo=0.5, hi=0.999), randn(1, 16, 64), \
        randn(1, 64)
    x = randn(1, 4, 2, 64)
    for what, bad in (
            ("rglru bf16", lambda: rglru_scan(a.bfloat16(), b.bfloat16())),
            ("rglru h0 shape", lambda: rglru_scan(a, b, h0[:, :8])),
            ("wkv N=32", lambda: wkv_scan(*(randn(1, 4, 2, 32),) * 4,
                                          randn(2, 32))),
            ("wkv N=128", lambda: wkv_scan(*(randn(1, 4, 2, 128),) * 4,
                                           randn(2, 128))),
            ("wkv non-contiguous", lambda: wkv_scan(
                x, x, x, x.transpose(1, 2), randn(2, 64))),
            ("wkv u on the CPU", lambda: wkv_scan(x, x, x, x,
                                                  torch.zeros(2, 64))),
            ("wkv misaligned", lambda: wkv_scan(
                *(randn(4 * 2 * 64 + 1)[1:].view(1, 4, 2, 64),) * 4,
                randn(2, 64)))):
        try:
            bad()
        except ValueError:
            continue
        fail(f"the wrapper took an input its kernel does not: {what}")
    if (rglru_scan.launches, wkv_scan.launches) != n0:
        fail("a refused input was counted as a launch")
    log("  recurrent wrappers refuse wrong dtypes, shapes, layouts and "
        "devices with ValueError: ok")

    S, window = 2048, 2048
    q, k, v = randn(1, Hq, S, hd), randn(1, KV, S, hd), randn(1, KV, S, hd)
    flops = flash_flops(1, Hq, S, hd, S, 0, True, window)
    bound, bound_by, simt = flash_bound_ms(
        4 * (2 * q.numel() + k.numel() + v.numel()), flops)
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                         window=window))
    plain_ms = cuda_ms(lambda: flash_attention_plain(
        q, k, v, causal=True, window=window), iters=5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    log(f"  flash hd=256 q [1,{Hq},{S},{hd}] k/v [1,{KV},{S},{hd}] f32 "
        f"causal window {window}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
        f"{flops / 1e9:.1f} GFLOP x3 in TF32), CUDA-core bound {simt:.4f} ms")
    out["flash_attention_hd256"] = dict(
        max_abs_err=fl_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, simt_bound_ms=simt, library_ms=lib_ms,
        library="torch.nn.functional.scaled_dot_product_attention",
        shape=f"q [1,{Hq},{S},{hd}] f32, k/v [1,{KV},{S},{hd}], causal, "
              f"window {window}")
    return out


def moe_gmm_shapes():
    """Every shape phase 8's served path can give ``gmm``: a gate/up
    ``(E, C, d_model, d_ff)`` and a down ``(E, C, d_ff, d_model)`` for each
    capacity C of a decode or fill step (``MOE_MAX_BATCH`` tokens) and of a
    prefill of each bucket up to ``MOE_MAX_SEQ`` (16-2,048 tokens: C = 8,
    16, 24, 40, 80, 160, 320 at Phi-3.5-MoE's E = 16, top-2, factor
    1.25)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    from repro_torch.serving.engine import _bucket
    cfg = get_config(MOE_NAME)
    E, K, d, f = (cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model,
                  cfg.d_ff)
    tokens, T = {MOE_MAX_BATCH}, _bucket(1)
    while T <= MOE_MAX_SEQ:
        tokens.add(T)
        T *= 2
    caps = sorted({capacity(T, E, K, cfg.moe_capacity_factor)
                   for T in tokens})
    return [(E, C, d, f) for C in caps] + [(E, C, f, d) for C in caps]


def gmm_bound_ms(E, C, d, f):
    """(bound ms, "bytes" | "operations", the SIMT bound ms) of ``gmm``.

    The card can do the f32-accurate product in 3xTF32 on its tensor cores
    (three TF32 products per f32 one, the kernel's route above C = 16) at
    495 / 3 TFLOP/s, faster than on the CUDA cores at 67: so the bound is
    the larger of the bytes at the memory rate and 3 x 2 C d f at the TF32
    peak. The bound on the CUDA cores alone (2 C d f at 67 TFLOP/s) is
    kept beside it, the one PR 16 reported."""
    nbytes = 4 * (E * C * d + E * d * f + E * C * f)
    flops = 2 * E * C * d * f
    bound, bound_by = bound_ms(nbytes, 3 * flops, PEAK_FLOPS["tf32"])
    return bound, bound_by, bound_ms(nbytes, flops)[0]


def phase_gmm_kernel():
    """``gmm`` against its plain version at every shape phase 8's path can
    give it (``moe_gmm_shapes``: both kernel paths, C <= 16 and C > 16)
    and at ragged ones (with and without 16-byte rows, at each row tile's
    edges C = 17, 33, 65, 129), and with NaN and Inf among the inputs;
    then at each path shape the kernel's and
    the plain version's errors against the product in f64, and the
    kernel timed with a cold L2 beside the plain version and
    ``torch.bmm`` (TF32 off), which the tensor-core path (C > 16) must not
    be slower than. Returns {shape: row}, each row with its own shape's
    error."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.gmm import gmm, gmm_plain

    log("== phase 2c: gmm (grouped matmul) vs its plain version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(E, C, d, f):
        # x like a normed hidden state; w as dense_init draws it
        return (torch.randn(E, C, d, device=dev, generator=gen),
                torch.randn(E, d, f, device=dev, generator=gen) * d ** -0.5)

    path = moe_gmm_shapes()
    ragged = ((3, 60, 100, 300), (2, 37, 99, 203), (3, 5, 99, 77),
              (2, 13, 64, 130), (2, 13, 64, 128), (1, 17, 1, 3),
              (2, 17, 96, 260), (2, 17, 97, 261), (2, 33, 128, 132),
              (2, 33, 130, 131), (2, 65, 256, 384), (2, 65, 255, 383),
              (2, 129, 512, 136), (2, 129, 513, 135))
    errs = {}
    for E, C, d, f in (*path, *ragged):
        x, w = inputs(E, C, d, f)
        errs[(E, C, d, f)] = check_close(
            f"gmm [{E},{C},{d}] @ [{E},{d},{f}] f32", ops.gmm(x, w),
            gmm_plain(x, w), "float32")
        del x, w
    # NaN (with payloads that the TF32 rounding's integer add could carry
    # into the exponent or sign) and Inf in x and w, on both paths: every
    # output is NaN, +Inf or -Inf exactly where the plain version's is, and
    # the finite ones agree within the tolerance
    import numpy as np
    bits = np.array([0x7FFFF000, 0xFFFFF001, 0x7F800001, 0x7FC00000],
                    dtype=np.uint32)
    nans = torch.from_numpy(bits.view(np.float32)).to(dev)
    for E, C, d, f in ((2, 13, 64, 128), (2, 33, 128, 132),
                       (2, 65, 255, 383)):
        x, w = inputs(E, C, d, f)
        x[0, 3, 5], x[1, C - 1, d - 1] = nans[0], nans[1]
        w[0, 7, 9], w[1, d // 2, f - 1] = nans[2], nans[3]
        x[0, 10, 0], w[1, 0, 2] = float("inf"), float("-inf")
        got, want = ops.gmm(x, w), gmm_plain(x, w)
        fin = torch.isfinite(want)
        ok = (bool(got.isnan()[want.isnan()].all())
              and torch.equal(torch.isfinite(got), fin)
              and torch.equal(got.isposinf(), want.isposinf())
              and torch.equal(got.isneginf(), want.isneginf())
              and torch.allclose(got[fin], want[fin], **TOL["float32"]))
        log(f"  gmm [{E},{C},{d}] @ [{E},{d},{f}] with NaN and Inf inputs: "
            f"{int(want.isnan().sum())} NaN and {int(want.isinf().sum())} "
            f"Inf outputs in the plain version, {int(got.isnan().sum())} "
            f"and {int(got.isinf().sum())} in the kernel's: "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("gmm lost a NaN or an Inf, or made one, against its plain "
                 "version")
        del x, w
    # refusals before any launch
    n0 = gmm.launches
    x, w = inputs(2, 8, 16, 32)
    for what, bad in (("bf16", lambda: gmm(x.bfloat16(), w.bfloat16())),
                      ("d mismatch", lambda: gmm(x, w[:, :8])),
                      ("E mismatch", lambda: gmm(x, w[:1])),
                      ("non-contiguous", lambda: gmm(x.transpose(1, 2),
                                                     w[:, :8])),
                      ("w on the CPU", lambda: gmm(x, w.cpu()))):
        try:
            bad()
        except ValueError:
            continue
        fail(f"the gmm wrapper took an input its kernel does not: {what}")
    if gmm.launches != n0:
        fail("a refused gmm input was counted as a launch")
    log("  gmm refuses other dtypes, shapes, layouts and devices with "
        "ValueError: ok")

    rows, slower = {}, []
    for E, C, d, f in path:
        x, w = inputs(E, C, d, f)
        # both against the product in f64: how far each is from the exact
        # result, where check_close above measured them against each other
        exact = torch.bmm(x.double(), w.double())
        f64_err = {name: (out.double() - exact).abs().max().item()
                   for name, out in (("kernel", gmm(x, w)),
                                     ("plain", gmm_plain(x, w)))}
        del exact
        log(f"  gmm [{E},{C},{d}] @ [{E},{d},{f}] against f64: kernel "
            f"{f64_err['kernel']:.3e}, plain {f64_err['plain']:.3e}")
        bound, bound_by, simt = gmm_bound_ms(E, C, d, f)
        ms = cuda_ms(lambda: gmm(x, w))
        plain_ms = cuda_ms(lambda: gmm_plain(x, w))
        lib_ms = cuda_ms(lambda: torch.bmm(x, w))
        log(f"  gmm [{E},{C},{d}] @ [{E},{d},{f}] f32 "
            f"({'small-C' if C <= 16 else 'tensor-core'} path): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} "
            f"ms, bound {bound:.4f} ms ({bound_by}; "
            f"{2 * E * C * d * f / 1e9:.1f} GFLOP, x3 in TF32 at 495 "
            f"TFLOP/s; {4 * E * d * f / 1e9:.2f} GB of weights), CUDA-core "
            f"bound {simt:.4f} ms")
        if C > 16 and ms > lib_ms:
            slower.append((E, C, d, f))
        rows[(E, C, d, f)] = dict(
            max_abs_err=errs[(E, C, d, f)], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
            library="torch.bmm (f32, TF32 off)", simt_bound_ms=simt,
            f64_err=f64_err,
            shape=f"x [{E},{C},{d}] f32, w [{E},{d},{f}]")
        del x, w
    torch.cuda.empty_cache()
    if slower:
        fail(f"gmm's tensor-core path is slower than torch.bmm at {slower}")
    log("  gmm above C = 16 is faster than torch.bmm at every shape: ok")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def _text(n: int, seed: int) -> str:
    import numpy as np
    rng = np.random.default_rng(seed)
    return "".join(chr(c) for c in rng.integers(97, 123, size=n))


def check_small_reference(name, *, max_seq, lengths, new_tokens, tol,
                          note=""):
    """The reduced model on the GPU (kernels) against the same weights on
    the CPU (the kernels' plain versions): greedy tokens identical and
    the longest prompt's prefill logits within atol = rtol = ``tol``."""
    import torch
    from repro_torch.core.assets import EXCHANGE

    kw = dict(smoke=True, max_seq=max_seq, max_batch=3, seed=1)
    gpu = EXCHANGE.get(name).build(device="cuda", **kw)
    cpu = EXCHANGE.get(name).build(device="cpu", params=_to_numpy(gpu.params),
                                   **kw)
    prompts = [[256] + list(range(1, 1 + n)) for n in lengths]
    got = gpu.engine.generate(prompts, max_new_tokens=new_tokens)
    want = cpu.engine.generate(prompts, max_new_tokens=new_tokens)
    if [r.tokens for r in got] != [r.tokens for r in want]:
        fail(f"reduced {name}: GPU greedy tokens differ from the CPU "
             "reference")
    toks = torch.tensor([prompts[-1]])
    lg, _ = gpu.model.prefill(gpu.params, {"tokens": toks.cuda()})
    lc, _ = cpu.model.prefill(cpu.params, {"tokens": toks})
    err = (lg.cpu() - lc).abs().max().item()
    if not torch.allclose(lg.cpu(), lc, atol=tol, rtol=tol):
        fail(f"reduced {name}: prefill logits differ by {err:.3e}")
    log(f"  reduced {name}, GPU kernels vs CPU plain versions: "
        f"{len(prompts)} prompts x {new_tokens} greedy tokens identical"
        f"{note}; prefill logits max_abs_err {err:.3e} (tolerance atol "
        f"{tol:g} rtol {tol:g})")


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

    log("== phase 3: contiguous path")
    # max_seq 48 < the reduced 64-token window: a linear cache, so decode
    # runs the decode kernel (a cache exactly one window long is a ring)
    check_small_reference("qwen3-4b", max_seq=48, lengths=(3, 17, 24),
                          new_tokens=16, tol=1e-4)

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
    # the token ids each request emitted, as the service hands them to the
    # wrapper's formatter (phase 4c holds streamed ids to them)
    emitted, fmt = {}, wrapper.format_generation
    wrapper.format_generation = lambda toks, n: (
        emitted.setdefault(n, list(toks)), fmt(toks, n))[1]
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
    del wrapper.format_generation
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
        f"{ttft_text(stats)}")
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
    ids = [emitted[len(wrapper.prepare_generation(inp)[0])]
           for inp in inputs[:4]]
    return launches, inputs[:4], outs[:4], ids


def run_chunk(eng, gen, temps, budgets, k):
    """One decode chunk driven as the scheduler drives it: on a paged
    engine every budgeted write gets its page (``ensure_capacity``) before
    the chunk is dispatched."""
    if eng.paged:
        budgets = budgets.copy()
        for slot in range(eng.max_batch):
            if budgets[slot] > 0:
                budgets[slot] = eng.ensure_capacity(
                    slot, min(k, int(budgets[slot])))
    return eng.step_chunk(gen, temps, budgets, k)


def profile_decode(eng, label="contiguous"):
    """Where a decode step's time goes: one 8-step chunk at B=4 timed on
    the host clock, then traced with torch.profiler (device busy time and
    the kernels that fill it). Launches here are outside the main-path
    counts."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import _bucket

    eng.reset()
    lens = (100, 500, 1000, 1500)
    how = ("prefill, bucket {}" if eng.prefix_cache is None
           else "prefill of the aligned part, bucket {}, then the tail "
                "as decode steps")
    for slot, n in enumerate(lens):
        # distinct first tokens: no prompt shares a page with another
        prompt = [256] + [97 + (i + 5 * slot) % 26 for i in range(n - 1)]
        t0 = time.perf_counter()
        eng.insert_request(prompt, slot)
        torch.cuda.synchronize()
        aligned = n if eng.prefix_cache is None else \
            (n - 1) // eng.page_size * eng.page_size
        log(f"  admission of {n} tokens ({how.format(_bucket(aligned))}): "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    gen = torch.Generator(device="cuda").manual_seed(0)
    temps = np.zeros((eng.max_batch,), np.float32)
    budgets = np.full((eng.max_batch,), 64, np.int32)
    _, emitted = run_chunk(eng, gen, temps, budgets, 8)  # warm-up
    eng.commit_chunk(emitted.sum(1).cpu().numpy())
    t0 = time.perf_counter()
    _, emitted = run_chunk(eng, gen, temps, budgets, 8)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 8
    eng.commit_chunk(emitted.sum(1).cpu().numpy())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_chunk(eng, gen, temps, budgets, 8)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's row also carries the device
    # time of the kernels it launched, which would count twice
    rows = [(evt.self_device_time_total, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    busy = sum(r[0] for r in rows) / 1e3 / 8
    n_kernels = sum(r[1] for r in rows) / 8
    log(f"  {label} decode step at B=4, contexts {lens}: {wall:.2f} ms wall, "
        f"{busy:.2f} ms device busy ({100 * (1 - busy / wall):.0f}% idle), "
        f"{n_kernels:.0f} kernels per step (host clock; torch.profiler)")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev_us / 1e3 / 8:7.3f} ms/step  {count // 8:5d}/step  "
            f"{key[:90]}")


def http(url, method, path, payload=None, timeout=600, headers=None,
         with_headers=False):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url + path, data,
                                 {"Content-Type": "application/json",
                                  **(headers or {})}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            out = r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        out = e.code, json.loads(e.read()), dict(e.headers)
    return out if with_headers else out[:2]


def predict_all(url, name, requests, clients=None):
    """POST every (route, input) at once — route "v2" or "v1", the i-th
    as client ``clients[i]`` when given; returns (envelopes, wall s)."""
    paths = {"v2": f"/v2/model/{name}/predict", "v1": f"/model/{name}/predict"}
    outs = [None] * len(requests)
    gate = threading.Barrier(len(requests))

    def go(i):
        route, inp = requests[i]
        gate.wait(timeout=60)
        outs[i] = http(url, "POST", paths[route], {"input": inp},
                       headers={"X-MAX-Client": clients[i]} if clients
                       else None)

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail("an HTTP request did not return")
    for (_, inp), out in zip(requests, outs):
        if out is None or out[0] != 200 or out[1].get("status") != "ok":
            fail(f"HTTP predict failed: {out}")
        n = out[1]["predictions"][0]["generated_tokens"]
        if not 1 <= n <= inp["max_new_tokens"]:
            fail(f"HTTP predict returned {n} tokens for max_new_tokens "
                 f"{inp['max_new_tokens']}")
    return [o[1] for o in outs], wall


def deploy(url, body):
    t0 = time.perf_counter()
    code, env = http(url, "POST", "/v2/model/qwen3-4b/deploy", body)
    if code != 200 or env.get("status") != "ok":
        fail(f"deploy {body} failed: {code} {env}")
    kv = env["kv_cache"]
    if not kv["paged"] or kv["pool_blocks"] != 512 or kv["page_size"] != 16:
        fail(f"deploy {body} did not give the 512 x 16 pool: {kv}")
    log(f"  deployed qwen3-4b {body} in {time.perf_counter() - t0:.1f} s: "
        f"pool {kv['pool_blocks']} pages of {kv['page_size']} tokens, "
        f"{kv['kv_bytes_per_token']} B per token")
    return env


def ttft_of_next(svc, fn):
    """Run ``fn`` (one request alone) and return its TTFT on the service's
    clock (submit to the first token's host read), the one observation
    it adds to the service's TTFT histogram."""
    h = svc.metrics.histogram("max_ttft_seconds", model=svc.model_id)
    n0, sum0 = h.count, h.sum
    out = fn()
    if h.count != n0 + 1:
        fail("a solo request did not record one TTFT")
    return out, h.sum - sum0


def check_pool(dep, label):
    eng = dep.wrapper.engine
    eng.check_pool_invariants()
    kv = eng.kv_stats()
    if kv["blocks_in_use"] != 0 or kv["active_slots"] != 0:
        fail(f"{label}: pages still in use after every request retired: "
             f"{kv}")
    cached = kv.get("cached_blocks", 0)
    if kv["free_blocks"] + cached != eng.kv_pool_blocks:
        fail(f"{label}: pages leaked: {kv}")
    log(f"  {label}: pool invariants hold; {kv['free_blocks']} free + "
        f"{cached} cached = {eng.kv_pool_blocks} pages, none in use")


def phase_http(cfg, server, greedy_inputs, contiguous_outs):
    """The HTTP front over the paged pool and the prefix cache, full width:
    every decode and fill step must launch the paged kernel (36 per step)
    and none the contiguous one. ``server`` is left running for phase
    4c."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention

    log("== phase 4: HTTP path (paged KV pool, prefix cache)")
    L = cfg.num_layers
    paged_decode_attention.launches = 0
    decode_attention.launches = 0
    flash_attention.launches = 0
    steps = prefills = 0

    # 1. paged, no prefix cache: the contiguous phase's greedy requests
    deploy(server.url, {"paged": True})
    dep = server.manager.get("qwen3-4b")
    eng = dep.wrapper.engine
    s0, p0 = eng.steps_dispatched, eng.prefills_dispatched
    outs, wall = predict_all(server.url, "qwen3-4b",
                             [("v2", inp) for inp in greedy_inputs])
    steps += eng.steps_dispatched - s0
    prefills += eng.prefills_dispatched - p0
    for got, want in zip(outs, contiguous_outs):
        if got["predictions"] != want["predictions"]:
            fail("paged greedy tokens differ from the contiguous "
                 "engine's for the same request")
    toks = sum(e["predictions"][0]["generated_tokens"] for e in outs)
    log(f"  paged: 4 greedy v2 predicts equal the contiguous engine's "
        f"tokens; {toks} tokens in {wall:.2f} s "
        f"({toks / wall:.1f} tokens/s end to end)")
    check_pool(dep, "paged")
    dep = eng = None      # the redeploy frees this model's memory first

    # 2. paged + prefix cache: four greedy requests sharing a 1,023-
    #    character prefix (1,024 tokens with BOS: 64 pages), one
    #    sampled request, then a warm replay
    deploy(server.url, {"paged": True, "prefix_cache": True})
    dep = server.manager.get("qwen3-4b")
    eng, svc = dep.wrapper.engine, dep.service
    shared = _text(1023, 100)
    inputs = [{"text": shared + _text(8 + 2 * i, 200 + i),
               "max_new_tokens": 32} for i in range(4)]
    inputs.append({"text": _text(30, 300), "max_new_tokens": 24,
                   "temperature": 0.8})
    s0, p0 = eng.steps_dispatched, eng.prefills_dispatched
    # a cold solo request on another 1,023-character prefix: its TTFT
    # is the cold one (1,024-token prefill + tail fill)
    cold_in = {"text": _text(1023, 400) + _text(10, 401),
               "max_new_tokens": 8}
    _, ttft_cold = ttft_of_next(svc, lambda: predict_all(
        server.url, "qwen3-4b", [("v2", cold_in)]))
    # the token ids each request emitted, as the service hands them to
    # the wrapper's formatter (the envelope carries only their text)
    emitted, fmt = {}, dep.wrapper.format_generation
    dep.wrapper.format_generation = lambda toks, n: (
        emitted.setdefault(n, list(toks)), fmt(toks, n))[1]
    outs, wall = predict_all(server.url, "qwen3-4b",
                             [("v2", inp) for inp in inputs])
    del dep.wrapper.format_generation
    hits0 = svc.stats()["prefix_cache"]["hit_tokens"]
    (replay, _), ttft_warm = ttft_of_next(svc, lambda: predict_all(
        server.url, "qwen3-4b", [("v2", inputs[0])]))
    steps += eng.steps_dispatched - s0
    prefills += eng.prefills_dispatched - p0
    stats = svc.stats()
    if replay[0]["predictions"] != outs[0]["predictions"]:
        fail("the warm replay's tokens differ from its first run")
    if stats["prefix_cache"]["hit_tokens"] - hits0 < 1024:
        fail("the replay did not hit the 64 cached prefix pages")
    toks = sum(e["predictions"][0]["generated_tokens"] for e in outs)
    pc = stats["prefix_cache"]
    log(f"  prefix: 5 concurrent v2 predicts (4 greedy sharing 1,024 "
        f"prefix tokens, 1 sampled at 0.8): {toks} tokens in "
        f"{wall:.2f} s ({toks / wall:.1f} tokens/s end to end); mean "
        f"batch {stats['mean_batch_size']}, max "
        f"{stats['max_batch_seen']}")
    log(f"  prefix: warm replay equals its first run; TTFT cold "
        f"{ttft_cold * 1e3:.1f} ms (1,024-token prefill + tail fill), "
        f"warm {ttft_warm * 1e3:.1f} ms (64 cached pages + tail fill)")
    log(f"  prefix cache: hit tokens {pc['hit_tokens']}, hits "
        f"{pc['hits']}, misses {pc['misses']}, registered "
        f"{pc['registered']}, copy-on-write {pc['cow_copies']}, "
        f"cached pages {pc['cached_pages']}")
    check_pool(dep, "prefix")
    log(f"  pool after the run: {json.dumps(stats['kv_cache'])}")

    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    if launches["decode_attention"] != 0:
        fail(f"the paged path launched the contiguous decode kernel "
             f"{launches['decode_attention']} times")
    if launches["paged_decode_attention"] != L * steps or steps == 0:
        fail(f"paged launches {launches['paged_decode_attention']} != "
             f"{L} x {steps} decode and fill steps")
    if launches["flash_attention"] != L * prefills:
        fail(f"flash launches {launches['flash_attention']} != {L} x "
             f"{prefills} prefills")
    log(f"  launches: paged {launches['paged_decode_attention']} "
        f"({steps} decode and fill steps x {L} layers), contiguous "
        f"decode 0, flash {launches['flash_attention']} ({prefills} "
        f"prefills x {L} layers)")
    check_prefix_reference(dep, inputs[:4], emitted)
    sync_free_paged_chunk(eng)
    profile_decode(eng, "paged (prefix cache on)")
    eng.reset()
    return launches


def check_prefix_reference(dep, inputs, emitted):
    """The prefix path held against a path that shares none of its parts:
    the model's scoring forward over the whole sequence (flash attention on
    f32 K/V; no cache, no pool, no decode kernel).

    - Every greedy token the concurrent prefix requests emitted (three of
      them prefix hits, their fills running beside other slots' decode)
      must be the forward's argmax (:func:`check_against_forward`).
    - A warm admission (64 cached pages by reference, the tail through
      masked paged decode steps) gives first-token logits within
      atol = 0.1 x the std of the forward's logits at the prompt's end.

    Launches made here are outside the main-path counts."""
    import torch
    wrapper, eng = dep.wrapper, dep.wrapper.engine
    V = wrapper.cfg.vocab_size
    check_against_forward(wrapper, inputs, emitted, "prefix")

    prompt = wrapper.prepare_generation(inputs[1])[0]
    rows, first_token = [], eng._first_token
    eng._first_token = lambda row, slot: (rows.append(row.clone()),
                                          first_token(row, slot))[1]
    hit0 = eng.prefix_stats()["hit_tokens"]
    try:
        eng.insert_request(prompt, 0)
    finally:
        del eng._first_token
    hit = eng.prefix_stats()["hit_tokens"] - hit0
    eng.release_slot(0)
    if hit < 1024:
        fail(f"the warm admission hit {hit} cached tokens, not the 1,024 "
             f"of the shared prefix")
    with torch.no_grad():
        ref = wrapper.model.forward(
            wrapper.params, {"tokens": torch.tensor([prompt], device="cuda")})
    ref, got = ref[0, -1, :V], rows[0][:V]
    err = (got - ref).abs().max().item()
    tol = 0.1 * ref.std().item()
    if not err <= tol:
        fail(f"warm prefix admission: first-token logits differ from the "
             f"forward's by {err:.3e} (atol {tol:.3e})")
    eng.check_pool_invariants()
    log(f"  warm admission of {len(prompt)} tokens ({hit} from cached "
        f"pages, the rest filled): first-token logits max_abs_err {err:.3e} against the "
        f"scoring forward (atol 0.1 std = {tol:.3e})")


def sync_free_paged_chunk(eng):
    """One 8-step chunk on the prefix-cached paged engine under
    set_sync_debug_mode("error"), with a page allocated and a table row
    pushed inside it. The service is idle; the engine is reset after."""
    import numpy as np
    import torch
    eng.reset()
    eng.insert_request([256] + list(range(65, 65 + 40)), 0)
    eng.insert_request([256] + list(range(65, 65 + 9)), 1)
    torch.cuda.synchronize()
    pages0 = eng.blocks_in_use()
    gen = torch.Generator(device="cuda").manual_seed(0)
    temps = np.asarray([0.0, 0.8, 0.0, 0.0], np.float32)
    budgets = np.asarray([8, 8, 0, 0], np.int32)
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emitted = run_chunk(eng, gen, temps, budgets, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if toks.shape != (4, 8) or not bool(emitted[:2].all()):
        fail("sync-free paged decode chunk returned a wrong block")
    if eng.blocks_in_use() <= pages0:
        fail("the paged chunk allocated no page")
    eng.reset()
    log("  one 8-step paged chunk (a page allocated, a table row pushed) "
        "ran under torch.cuda.set_sync_debug_mode('error'): no host sync")


# ---------------------------------------------------------------------------
# phase 4c: the request lifecycle over HTTP
# ---------------------------------------------------------------------------

# one QoS config for phase 4c's deployment: two requests at once per
# client, then one every 20 s (every client of the phase but "flood"
# sends at most two)
LIFECYCLE_QOS = {"rate": 0.05, "burst": 2}


class SyncCounter:
    """Host syncs by thread name while active: explicit reads of a CUDA
    tensor (``.cpu``, ``.item``, ``.tolist``, ``.numpy`` and ``bool``,
    ``int`` or ``float`` of one, through patched ``torch.Tensor``
    methods) in ``reads``, and every synchronizing CUDA operation that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports in ``syncs``."""

    NAMES = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
             "__float__")

    def __enter__(self):
        import collections
        import warnings
        import torch
        self.reads = collections.Counter()
        self.syncs = collections.Counter()
        self._orig = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        for name, orig in self._orig.items():
            def wrap(t, *a, _orig=orig, **kw):
                if t.is_cuda:
                    self.reads[threading.current_thread().name] += 1
                return _orig(t, *a, **kw)
            setattr(torch.Tensor, name, wrap)
        self._warn = warnings.catch_warnings()
        self._warn.__enter__()
        warnings.simplefilter("always")
        show = warnings.showwarning
        self.where = collections.Counter()

        def count(message, category, *a, **kw):
            if "synchroniz" in str(message):
                name = threading.current_thread().name
                self.syncs[name] += 1
                # the innermost frame of the port that made the call
                import traceback
                port = [f for f in traceback.extract_stack()
                        if "repro_torch" in f.filename]
                where = (f"{Path(port[-1].filename).name}:{port[-1].lineno}"
                         f" {port[-1].line}" if port else "?")
                self.where[(name, where)] += 1
            else:
                show(message, category, *a, **kw)
        warnings.showwarning = count
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode("default")
        self._warn.__exit__(*exc)
        for name, orig in self._orig.items():
            setattr(torch.Tensor, name, orig)


def sse_open(url, path, payload=None, headers=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url + path, data, {"Content-Type": "application/json",
                           **(headers or {})},
        method="POST" if payload is not None else "GET")
    resp = urllib.request.urlopen(req, timeout=600)
    if resp.headers["Content-Type"] != "text/event-stream" \
            or resp.headers.get("Content-Length") is not None:
        fail(f"{path}: not an unsized event stream: {dict(resp.headers)}")
    return resp


def sse_read(resp, t0, limit=None):
    """[(seconds since ``t0`` at arrival, {"id", "event", "data"})], up to
    ``limit`` events or the end of the stream."""
    events, cur = [], {}
    for raw in resp:
        line = raw.decode().rstrip("\n")
        if not line:
            if cur:
                events.append((time.perf_counter() - t0, cur))
                cur = {}
                if limit is not None and len(events) >= limit:
                    break
            continue
        key, _, val = line.partition(": ")
        cur[key] = json.loads(val) if key == "data" else val
    return events


def check_stream(label, events, want_ids, want_preds):
    """One stream's framing and tokens: ``id`` rises by 1 from 0, token
    events then exactly one ``done`` carrying the predict envelope, and
    the deltas concatenate to the contiguous engine's ids."""
    seqs = [int(e["id"]) for _, e in events]
    kinds = [e["event"] for _, e in events]
    if seqs != list(range(len(events))):
        fail(f"{label}: ids {seqs} do not rise by 1 from 0")
    if kinds.count("done") != 1 or kinds[-1] != "done" \
            or set(kinds[:-1]) != {"token"}:
        fail(f"{label}: events {kinds}")
    ids = [t for _, e in events[:-1] for t in e["data"]["token_ids"]]
    if ids != want_ids:
        fail(f"{label}: streamed ids differ from the contiguous engine's")
    if events[-1][1]["data"]["envelope"]["predictions"] != want_preds:
        fail(f"{label}: the done envelope differs from predict's")
    return len(ids)


def check_live_gap(label, events, slack_s=0.005):
    """A live stream's first token event reaches the client a chunk or
    more before ``done`` (a writer that buffered its frames until the
    end, or never flushed, delivers them together). A chunk is the mean
    tick of the request's decode on the service clock, ``decode_ms``
    over the ``sched_ticks - 1`` ticks after the one that read its first
    token; ``slack_s`` covers the two frames' different delivery delays.
    Returns (gap, chunk) in seconds."""
    usage = events[-1][1]["data"]["usage"]
    if usage["sched_ticks"] < 2:
        fail(f"{label}: one tick, no chunk between the first token and "
             f"done: {usage}")
    chunk = usage["decode_ms"] / 1e3 / (usage["sched_ticks"] - 1)
    gap = events[-1][0] - events[0][0]
    if gap < chunk - slack_s:
        fail(f"{label}: the first token event arrived {gap * 1e3:.3f} ms "
             f"before done, under one chunk ({chunk * 1e3:.3f} ms)")
    return gap, chunk


def wait_until(pred, what, timeout_s=300):
    deadline = time.perf_counter() + timeout_s
    while not pred():
        if time.perf_counter() > deadline:
            fail(f"timed out waiting for {what}")
        time.sleep(0.005)


def job_state(url, jid):
    code, body = http(url, "GET", f"/v2/jobs/{jid}")
    if code != 200:
        fail(f"GET /v2/jobs/{jid}: {code} {body}")
    return body["job"]


def submit_job(url, inp, client, **qos):
    code, body = http(url, "POST", "/v2/model/qwen3-4b/jobs",
                      {"input": inp, **qos}, headers={"X-MAX-Client": client})
    if code != 202:
        fail(f"job submit {inp} answered {code} {body}")
    return body["job"]["id"]


def validate_chrome(events):
    """The subset of the Chrome trace-event schema the export uses."""
    if not isinstance(events, list) or not events:
        fail("trace export: no traceEvents")
    for ev in events:
        ok = (ev.get("ph") in ("X", "C", "M", "i")
              and isinstance(ev.get("pid"), int)
              and isinstance(ev.get("tid"), int) and ev.get("name"))
        if ev["ph"] == "X":
            ok = ok and ev["ts"] >= 0 and ev["dur"] > 0
        elif ev["ph"] == "C":
            ok = ok and bool(ev.get("args"))
        elif ev["ph"] == "i":
            ok = ok and ev.get("s") in ("t", "p", "g")
        if not ok:
            fail(f"trace export: bad event {ev}")


def parse_prometheus(text):
    """{series: value} of a text exposition; fails on a malformed line."""
    import re
    line_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^{}]*\})?) '
        r'(-?[0-9.]+(?:e[+-]?[0-9]+)?|NaN|[+-]Inf)$')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") \
                or line.startswith("# TYPE "):
            continue
        m = line_re.match(line)
        if m is None:
            fail(f"/v2/metrics?format=prometheus: bad line {line!r}")
        out[m.group(1)] = float(m.group(2))
    return out


def phase_lifecycle(cfg, server, card, greedy_inputs, contiguous_outs,
                    contiguous_ids):
    """Phase 4c: streams, jobs with resume and cancel, QoS admission,
    metrics, tracing and the sync service, over phase 4's server at full
    width. Returns the three dense kernels' launches in this phase."""
    import socket
    import struct
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention

    log("== phase 4c: the request lifecycle over HTTP")
    L, url = cfg.num_layers, server.url
    paged_decode_attention.launches = 0
    decode_attention.launches = 0
    flash_attention.launches = 0
    t_phase = time.perf_counter()

    def at():
        return f" [{time.perf_counter() - t_phase:.1f} s into 4c]"
    env = deploy(url, {"paged": True, "prefix_cache": True,
                       "qos": LIFECYCLE_QOS})
    if env["qos"]["rate"] != LIFECYCLE_QOS["rate"]:
        fail(f"the deploy did not take the QoS config: {env['qos']}")
    dep = server.manager.get("qwen3-4b")
    svc, eng = dep.service, dep.wrapper.engine
    ss = svc.scheduler.stats
    ttft_h = svc.metrics.histogram("max_ttft_seconds", model="qwen3-4b")
    s0, p0 = eng.steps_dispatched, eng.prefills_dispatched
    ticks0, reads0, chunks0 = ss.ticks, ss.host_reads, ss.chunks
    ttft0, generating = ttft_h.count, 0
    counter = SyncCounter()
    with counter:
        # a. four greedy streams at once, then the same as predicts
        res = [None] * 4
        gate = threading.Barrier(4)

        def stream(i):
            gate.wait(timeout=60)
            t0 = time.perf_counter()
            with sse_open(url, "/v2/model/qwen3-4b/stream",
                          {"input": greedy_inputs[i]},
                          {"X-MAX-Client": f"a{i}"}) as r:
                res[i] = sse_read(r, t0)

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_streams = time.perf_counter() - t0
        if any(r is None for r in res):
            fail("a stream did not finish")
        toks_streams = sum(
            check_stream(f"stream {i}", res[i], contiguous_ids[i],
                         contiguous_outs[i]["predictions"])
            for i in range(4))
        gaps = [check_live_gap(f"stream {i}", res[i]) for i in range(4)]
        ttft_streams = [r[0][0] for r in res]
        # the same TTFT on the service's clock (submit to the first
        # token's host read), from each stream's done usage
        ttft_served = [r[-1][1]["data"]["usage"]["ttft_ms"] for r in res]
        n0 = ttft_h.count
        outs, wall_predicts = predict_all(
            url, "qwen3-4b", [("v2", inp) for inp in greedy_inputs],
            clients=[f"a{i}" for i in range(4)])
        for got, want in zip(outs, contiguous_outs):
            if got["predictions"] != want["predictions"]:
                fail("4c predict tokens differ from the contiguous engine's")
        # the predicts' own TTFT observations (service clock: submit to
        # the first token's host read), the newest of the histogram
        ttft_predicts = list(ttft_h._ring)[-(ttft_h.count - n0):]
        toks_predicts = sum(e["predictions"][0]["generated_tokens"]
                            for e in outs)
        generating += 8
        log(f"  a. 4 concurrent streams equal the contiguous engine's ids "
            f"and predict's envelopes; ids rise by 1, one done each; "
            f"first token event before done by "
            f"{', '.join(f'{g * 1e3:.1f}' for g, _ in gaps)} ms, chunks "
            f"{', '.join(f'{c * 1e3:.1f}' for _, c in gaps)} ms")
        log(f"  a. streams: first token event at "
            f"{', '.join(f'{t * 1e3:.1f}' for t in ttft_streams)} ms "
            f"(client clock), TTFT "
            f"{', '.join(f'{t:.1f}' for t in ttft_served)} ms (service "
            f"clock); predicts after them (prefix hits on the streams' "
            f"pages): TTFT "
            f"{', '.join(f'{t * 1e3:.1f}' for t in sorted(ttft_predicts))}"
            f" ms (service clock) [{card}]")
        log(f"  a. 4 streams {toks_streams} tokens in {wall_streams:.2f} s "
            f"({toks_streams / wall_streams:.1f} tokens/s); 4 predicts "
            f"{toks_predicts} tokens in {wall_predicts:.2f} s "
            f"({toks_predicts / wall_predicts:.1f} tokens/s) [{card}]{at()}")

        # b. a job: three events, disconnect, resume with Last-Event-ID
        jid = submit_job(url, greedy_inputs[1], "job")
        t0 = time.perf_counter()
        r = sse_open(url, f"/v2/jobs/{jid}/events")
        head = sse_read(r, t0, limit=3)
        r.close()
        last = head[-1][1]["id"]
        with sse_open(url, f"/v2/jobs/{jid}/events",
                      headers={"Last-Event-ID": last}) as r:
            tail = sse_read(r, t0)
        check_stream("job events, resumed", head + tail, contiguous_ids[1],
                     contiguous_outs[1]["predictions"])
        wait_until(lambda: job_state(url, jid)["state"] == "done",
                   "the job to finish")
        job = job_state(url, jid)
        if job["result"]["predictions"] != contiguous_outs[1]["predictions"]:
            fail("the job's result differs from predict's")
        generating += 1
        log(f"  b. job {jid}: read {len(head)} events, disconnected, "
            f"resumed after id {last}: {len(head) + len(tail)} events with "
            f"no gap or duplicate; the result equals predict's{at()}")

        # c. cancel by disconnect: a 1,000-token prompt asking for 1,024,
        #    the socket reset after its first token event; the cancel's
        #    call and return are stamped (host clock, chunks done)
        cancelled0 = ss.cancelled
        marks, cancel = [], svc.scheduler.cancel

        def stamped_cancel(rid):
            marks.append((time.perf_counter(), ss.chunks))
            out = cancel(rid)
            marks.append((time.perf_counter(), ss.chunks))
            return out
        svc.scheduler.cancel = stamped_cancel
        body = json.dumps({"input": {"text": _text(999, 500),
                                     "max_new_tokens": 1024}}).encode()
        host, port = server._server.server_address[:2]
        sock = socket.create_connection((host, port))
        try:
            sock.sendall(
                f"POST /v2/model/qwen3-4b/stream HTTP/1.1\r\n"
                f"Host: {host}\r\nContent-Type: application/json\r\n"
                f"X-MAX-Client: cancel\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            buf = b""
            while b"event: token" not in buf or not buf.endswith(b"\n\n"):
                chunk = sock.recv(65536)
                if not chunk:
                    fail(f"the cancel stream closed early: {buf[:200]!r}")
                buf += chunk
        finally:
            chunks_at_drop = ss.chunks
            t_drop = time.perf_counter()
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
            sock.close()
        wait_until(svc.idle, "the service to go idle after the drop")
        idle_s = time.perf_counter() - t_drop
        after = ss.chunks - chunks_at_drop
        del svc.scheduler.cancel
        log(f"  c. cancel called {(marks[0][0] - t_drop) * 1e3:.1f} ms after "
            f"the drop ({marks[0][1] - chunks_at_drop} chunks), marked "
            f"{(marks[1][0] - t_drop) * 1e3:.1f} ms after it "
            f"({marks[1][1] - chunks_at_drop} chunks)" if len(marks) == 2
            else f"  c. cancel calls: {marks}")
        if ss.cancelled != cancelled0 + 1:
            fail(f"the drop cancelled {ss.cancelled - cancelled0} requests")
        if after > 2:
            fail(f"{after} chunks ran after the drop before the service "
                 "went idle (at most two)")
        check_pool(dep, "c. after the dropped stream")
        generating += 1
        log(f"  c. dropped stream: cancelled, the service idle "
            f"{idle_s * 1e3:.0f} ms and {after} chunk(s) after the drop")
        jid_del = submit_job(url, {"text": _text(20, 501),
                                   "max_new_tokens": 1024}, "del")
        wait_until(lambda: job_state(url, jid_del)["state"] == "running",
                   "the job to run")
        code, out = http(url, "DELETE", f"/v2/jobs/{jid_del}")
        if code != 200 or out.get("cancelled") != jid_del:
            fail(f"DELETE on a running job answered {code} {out}")
        wait_until(lambda: job_state(url, jid_del)["state"] != "running",
                   "the cancelled job to finish")
        job = job_state(url, jid_del)
        with sse_open(url, f"/v2/jobs/{jid_del}/events") as r:
            kinds = [e["event"] for _, e in sse_read(r, time.perf_counter())]
        if job["state"] != "cancelled" or "done" in kinds \
                or kinds[-1] != "error":
            fail(f"DELETE: state {job['state']}, events {kinds}")
        wait_until(svc.idle, "the service to go idle after DELETE")
        check_pool(dep, "c. after DELETE")
        generating += 1
        log(f"  c. DELETE on a running job: state cancelled after "
            f"{sum(k == 'token' for k in kinds)} token events, never done"
            f"{at()}")

        # d. priority: four best_effort jobs hold the batch, two more
        #    queue, then one interactive job; a deadline that cannot be
        #    met; a per-client rate limit
        holders = [submit_job(url, {"text": _text(12, 600 + i),
                                    "max_new_tokens": 24 if i == 0 else 40},
                              f"be{i}", priority="best_effort")
                   for i in range(4)]
        wait_until(lambda: all(job_state(url, j)["state"] == "running"
                               for j in holders), "four running holders")
        queued = [submit_job(url, {"text": _text(12, 610 + i),
                                   "max_new_tokens": 8}, f"be{4 + i}",
                             priority="best_effort") for i in range(2)]
        vip = submit_job(url, {"text": _text(12, 620), "max_new_tokens": 8},
                         "vip", priority="interactive")
        code, out, hdrs = http(url, "POST", "/v2/model/qwen3-4b/predict",
                               {"input": {"text": "late",
                                          "max_new_tokens": 4},
                                "deadline_ms": 1},
                               headers={"X-MAX-Client": "late"},
                               with_headers=True)
        if code != 504 or out["error"]["code"] != "DEADLINE_EXCEEDED":
            fail(f"an unmeetable deadline answered {code} {out}")
        for j in holders + queued + [vip]:
            wait_until(lambda j=j: job_state(url, j)["state"] == "done",
                       f"job {j}")
        ticks = {}
        for j in queued + [vip]:
            code, tr = http(url, "GET", f"/v2/jobs/{j}/trace")
            admits = [e for e in tr["trace"]["events"] if e["name"] == "admit"]
            ticks[j] = admits[0]["attrs"]["tick"]
        if not ticks[vip] < min(ticks[j] for j in queued):
            fail(f"the interactive job was admitted at tick {ticks[vip]}, "
                 f"the queued best_effort ones at "
                 f"{[ticks[j] for j in queued]}")
        generating += 7
        log(f"  d. interactive admitted at tick {ticks[vip]}, before the "
            f"queued best_effort at ticks {[ticks[j] for j in queued]}; "
            f"deadline_ms 1 behind a held batch: 504 DEADLINE_EXCEEDED")
        flood = [http(url, "POST", "/v2/model/qwen3-4b/predict",
                      {"input": {"text": "x", "max_new_tokens": 1}},
                      headers={"X-MAX-Client": "flood"}, with_headers=True)
                 for _ in range(3)]
        if [f[0] for f in flood] != [200, 200, 429] \
                or flood[2][1]["error"]["code"] != "RATE_LIMITED" \
                or not flood[2][2].get("Retry-After"):
            fail(f"the rate limit answered {[f[:2] for f in flood]}")
        generating += 2
        log(f"  d. a third request at once from one client: 429 "
            f"RATE_LIMITED, Retry-After {flood[2][2]['Retry-After']}{at()}")

        # e. metrics
        wait_until(svc.idle, "the service to go idle")
        code, text, _ = http_text(url, "/v2/metrics?format=prometheus")
        series = parse_prometheus(text)
        n_ttft = series['max_ttft_seconds_count{model="qwen3-4b"}'] - ttft0
        if n_ttft != generating:
            fail(f"max_ttft_seconds counted {n_ttft} requests in this "
                 f"phase, {generating} generated tokens")
        kv = svc.stats()["kv_cache"]
        gauges = (series['max_kv_pool_blocks_in_use{model="qwen3-4b"}'],
                  series['max_kv_pool_blocks_total{model="qwen3-4b"}'])
        if gauges != (kv["blocks_in_use"], kv["pool_blocks"]):
            fail(f"KV pool gauges {gauges} differ from stats {kv}")
        log(f"  e. /v2/metrics?format=prometheus: {len(series)} series "
            f"parse; max_ttft_seconds counted {int(n_ttft)} requests, the "
            f"phase's generating ones; KV pool gauges equal stats")

        # f. tracing
        code, tr = http(url, "GET", f"/v2/jobs/{jid}/trace")
        ph = tr["trace"]["phases"]
        gap = abs(ph["queue_ms"] + ph["prefill_ms"] + ph["decode_ms"]
                  - ph["e2e_ms"])
        if code != 200 or gap > 1.0:
            fail(f"job trace: phases {ph} (gap {gap} ms)")
        code, export = http(url, "GET", "/v2/trace/export")
        validate_chrome(export["traceEvents"])
        # the scheduler's tick lane: every tick of this deployment, and
        # the ones that dispatched a chunk (each must read the device once)
        tick_lane = [e for e in export["traceEvents"]
                     if e["ph"] == "X" and e.get("cat") == "scheduler"]
        chunk_ticks = sum(e["args"]["chunk_k"] > 0 for e in tick_lane)
        log(f"  f. job trace phases sum to e2e {ph['e2e_ms']} ms within "
            f"{gap:.3f} ms; /v2/trace/export: "
            f"{len(export['traceEvents'])} Chrome trace events{at()}")

    # h. the batched deployment's launches and host reads
    steps = eng.steps_dispatched - s0
    prefills = eng.prefills_dispatched - p0
    ticks, reads = ss.ticks - ticks0, ss.host_reads - reads0
    chunks = ss.chunks - chunks0
    worker = f"batched-{svc.model_id}"
    others = {k: v for k, v in (counter.reads + counter.syncs).items()
              if k not in (worker, "MainThread")}
    log(f"  h. batched: {ticks} ticks ({chunk_ticks} with a chunk, by the "
        f"trace's tick lane), {chunks} chunks, {reads} host reads; on the "
        f"worker {counter.reads[worker]} explicit reads and "
        f"{counter.syncs[worker]} synchronizing operations; longest tick "
        f"{max(e['dur'] for e in tick_lane) / 1e3:.1f} ms, "
        f"{svc.tick_stalls} over the {svc.stall_budget_s} s stall budget")
    if len(tick_lane) != ticks:
        fail(f"the trace holds {len(tick_lane)} ticks, the scheduler {ticks}")
    if not (reads == chunk_ticks == chunks and counter.reads[worker] == reads
            and counter.syncs[worker] == reads):
        for (name, where), n in counter.where.most_common():
            log(f"    {n} synchronizing operations on {name} at {where}")
        fail("the scheduler read the device more than once a tick")
    if others:
        fail(f"threads other than the worker touched the device: {others}")
    b_paged, b_decode = (paged_decode_attention.launches,
                         decode_attention.launches)
    b_flash = flash_attention.launches
    if b_decode != 0:
        fail(f"the batched deployment launched contiguous decode {b_decode}")
    if b_paged != L * steps or b_flash != L * prefills or steps == 0:
        fail(f"batched launches: paged {b_paged} for {steps} steps, flash "
             f"{b_flash} for {prefills} prefills ({L} layers)")
    dep = svc = eng = ss = None

    # g. the sync service on the contiguous layout
    code, env = http(url, "POST", "/v2/model/qwen3-4b/deploy",
                     {"service": "sync"})
    if code != 200 or env["service"] != "sync" or env["kv_cache"]["paged"]:
        fail(f"sync deploy answered {code} {env}")
    eng = server.manager.get("qwen3-4b").wrapper.engine
    s1, p1 = eng.steps_dispatched, eng.prefills_dispatched
    code, got = http(url, "POST", "/v2/model/qwen3-4b/predict",
                     {"input": greedy_inputs[1]})

    def strip(preds):
        return [{k: v for k, v in p.items() if k != "ttft_ms"}
                for p in preds]
    want = contiguous_outs[1]["predictions"]
    if code != 200 or strip(got["predictions"]) != want:
        fail(f"the sync predict differs from the batched deployment's: "
             f"{got}")
    with sse_open(url, "/v2/model/qwen3-4b/stream",
                  {"input": greedy_inputs[1]}) as r:
        events = [e for _, e in sse_read(r, time.perf_counter())]
    if [(e["event"], e["id"]) for e in events] != [("token", "0"),
                                                   ("done", "1")] \
            or events[0]["data"]["text"] != want[0]["generated_text"] \
            or strip(events[1]["data"]["envelope"]["predictions"]) != want:
        fail(f"the sync stream is not the whole-result fallback: {events}")
    sync_steps = eng.steps_dispatched - s1
    sync_prefills = eng.prefills_dispatched - p1
    s_decode = decode_attention.launches
    s_flash = flash_attention.launches - b_flash
    if paged_decode_attention.launches != b_paged \
            or s_decode != L * sync_steps or s_flash != L * sync_prefills:
        fail(f"sync launches: contiguous {s_decode} for {sync_steps} steps, "
             f"flash {s_flash} for {sync_prefills} prefills")
    log(f"  g. sync service, contiguous layout: predict equals the batched "
        f"deployment's tokens; its stream is one token event and done{at()}")
    log(f"  h. launches: batched paged {b_paged} ({steps} decode and fill "
        f"steps x {L}), flash {b_flash} ({prefills} prefills x {L}), "
        f"contiguous 0; sync contiguous {s_decode} ({sync_steps} steps x "
        f"{L}), flash {s_flash} ({sync_prefills} prefills x {L})")
    log(f"  phase 4c took {time.perf_counter() - t_phase:.1f} s")
    return {"paged_decode_attention": b_paged,
            "decode_attention": s_decode,
            "flash_attention": b_flash + s_flash}


def http_text(url, path):
    with urllib.request.urlopen(url + path, timeout=600) as r:
        return r.status, r.read().decode(), dict(r.headers)


# ---------------------------------------------------------------------------
# phase 4d: the robustness half over HTTP
# ---------------------------------------------------------------------------

# the JAX package's chaos scenario (benchmarks/run.py::bench_robustness):
# greedy requests against a fault-free twin under seeded per-chunk faults,
# retried with these knobs (the service's, not deploy fields, in both
# packages)
CHAOS_SPEC = {"chunk_rate": 0.05, "seed": 7}
CHAOS_RETRIES, CHAOS_BACKOFF_S = 5, 0.01
# one page of full-width qwen3-4b's pool: 16 tokens x 36 layers x K and V
# x 8 KV heads x 128 x 2 bytes (bf16)
PAGE_BYTES = 16 * 36 * 2 * 8 * 128 * 2


def scheduler_ticks(url):
    """The scheduler's tick lane of the deployed service's trace."""
    code, export = http(url, "GET", "/v2/trace/export")
    if code != 200:
        fail(f"/v2/trace/export answered {code}")
    return [e for e in export["traceEvents"]
            if e["ph"] == "X" and e.get("cat") == "scheduler"]


def phase_robustness(cfg, server, card, greedy_inputs, contiguous_outs,
                     contiguous_ids):
    """Phase 4d: fault injection, safe retry, the watchdog, engine rebuild,
    brownout and ``/v2/health`` over phase 4's server at full width, after
    the JAX chaos scenario. Returns the three dense kernels' launches in
    this phase. Each step is a function of its own, so that no reference
    to a deployment outlives the redeploy that replaces it."""
    import torch
    from repro_torch.data.tokenizer import TOKENIZER
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving.engine import GenerationEngine

    log("== phase 4d: the robustness half over HTTP")
    L, url = cfg.num_layers, server.url
    paged_decode_attention.launches = 0
    decode_attention.launches = 0
    flash_attention.launches = 0
    t_phase = time.perf_counter()
    totals = {"steps": 0, "prefills": 0}
    live, levels = {}, []

    def at():
        return f" [{time.perf_counter() - t_phase:.1f} s into 4d]"

    def tally():
        """The live engine's steps and prefills join the phase's totals."""
        eng = live.pop("eng", None)
        if eng is not None:
            totals["steps"] += eng.steps_dispatched - live["s0"]
            totals["prefills"] += eng.prefills_dispatched - live["p0"]

    def redeploy(body, **knobs):
        """Deploy over HTTP (paged, prefix cache, ``body``) and set the
        service's retry knobs; the old engine is tallied first. Returns
        (deployment, service, engine)."""
        tally()
        deploy(url, {"paged": True, "prefix_cache": True, **body})
        # one deployment on the card at a time: the old one's 17 GB are
        # gone before the new one is built
        levels.append(torch.cuda.memory_allocated())
        if levels[-1] > levels[0] + 1e9:
            fail(f"device memory grew over the redeploys: "
                 f"{[f'{m / 1e9:.2f}' for m in levels]} GB")
        dep = server.manager.get("qwen3-4b")
        for key, value in knobs.items():
            setattr(dep.service, key, value)
        eng = dep.wrapper.engine
        live.update(eng=eng, s0=eng.steps_dispatched,
                    p0=eng.prefills_dispatched)
        return dep, dep.service, eng

    def predict_batch(inputs):
        t0 = time.perf_counter()
        code, body = http(url, "POST", "/v2/model/qwen3-4b/predict_batch",
                          {"inputs": inputs})
        if code != 200:
            fail(f"predict_batch answered {code} {body}")
        return body["results"], time.perf_counter() - t0

    def longest_tick_ms():
        return max(e["dur"] for e in scheduler_ticks(url)) / 1e3

    # a. chaos against a fault-free twin: 16 greedy requests of 8 new
    #    tokens (prompts of 40 characters, two full pages each, so a
    #    retry meets the pages its faulted attempt registered)
    chaos_inputs = [{"text": _text(40, 700 + i), "max_new_tokens": 8}
                    for i in range(16)]

    def twin_run():
        redeploy({})
        twin, wall = predict_batch(chaos_inputs)
        if any(r["status"] != "ok" for r in twin):
            fail(f"the fault-free twin failed: {twin}")
        return twin, wall, longest_tick_ms()

    def chaos_run(twin, wall_twin, tick_twin):
        dep, svc, _ = redeploy({"faults": CHAOS_SPEC},
                               max_retries=CHAOS_RETRIES,
                               retry_backoff_s=CHAOS_BACKOFF_S)
        chaos, wall = predict_batch(chaos_inputs)
        rob = svc.stats()["robustness"]
        fired = rob["fault_injection"]["fired"]
        done = sum(r["status"] == "ok" for r in chaos)
        if done != len(chaos_inputs):
            fail(f"chaos: {done} of {len(chaos_inputs)} requests completed: "
                 f"{[r for r in chaos if r['status'] != 'ok']}")
        if [r["predictions"] for r in chaos] \
                != [r["predictions"] for r in twin]:
            fail("chaos: a retried request's tokens differ from its twin's")
        if fired["chunk"] == 0 or rob["engine_faults"] != fired["chunk"] \
                or rob["retries"] != rob["engine_faults"]:
            fail(f"chaos: faults fired {fired}, robustness {rob}")
        check_pool(dep, "a. after the chaos run")
        log(f"  a. chaos {CHAOS_SPEC}, max_retries {CHAOS_RETRIES}, backoff "
            f"{CHAOS_BACKOFF_S} s: {done} of {len(chaos_inputs)} complete "
            f"with their twin's tokens; fired {fired}, "
            f"{rob['engine_faults']} engine faults, {rob['retries']} "
            f"retries, {rob['engine_rebuilds']} rebuilds; wall twin "
            f"{wall_twin:.2f} s, chaos {wall:.2f} s; longest tick twin "
            f"{tick_twin:.1f} ms, chaos {longest_tick_ms():.1f} ms (stall "
            f"budget {svc.stall_budget_s} s, {rob['tick_stalls']} stalls) "
            f"[{card}]{at()}")

    def scripted(twin):
        """An admission fault at tick 0 and a scoped chunk fault on slot 2
        at tick 1, no retries: only the two victims retire."""
        dep, svc, _ = redeploy(
            {"faults": {"script": [{"tick": 0, "site": "admission"},
                                   {"tick": 1, "site": "chunk",
                                    "slot": 2}]}},
            max_retries=0)
        results, _ = predict_batch(chaos_inputs[:4])
        faulted = [i for i, r in enumerate(results) if r["status"] != "ok"]
        msgs = sorted(results[i]["error"]["message"] for i in faulted)
        want = ["engine fault during admission: injected admission fault "
                "at tick 0",
                "engine fault during chunk: injected chunk fault at tick 1 "
                "(slot 2)"]
        if msgs != want or any(results[i]["error"]["code"] != "ENGINE_FAULT"
                               for i in faulted):
            fail(f"scripted faults retired {[results[i] for i in faulted]}")
        for i, r in enumerate(results):
            if i not in faulted \
                    and r["predictions"] != twin[i]["predictions"]:
                fail(f"scripted faults: request {i}, not a victim, differs "
                     "from its twin")
        if svc.stats()["robustness"]["engine_faults"] != 2:
            fail(f"scripted faults: {svc.stats()['robustness']}")
        check_pool(dep, "a. after the scripted faults")
        log(f"  a. scripted admission (tick 0) and slot-2 chunk (tick 1) "
            f"faults retired only their victims (requests {faulted}); the "
            f"other two equal their twins{at()}")

    def stream_fault():
        """A stream that faults after its first token: a terminal error,
        no retry."""
        _, svc, _ = redeploy(
            {"faults": {"script": [{"tick": 1, "site": "chunk"}]}})
        with sse_open(url, "/v2/model/qwen3-4b/stream",
                      {"input": greedy_inputs[0]}) as r:
            events = [e for _, e in sse_read(r, time.perf_counter())]
        kinds = [e["event"] for e in events]
        ids = [t for e in events if e["event"] == "token"
               for t in e["data"]["token_ids"]]
        want_ids = contiguous_ids[0]
        if not 0 < len(ids) < len(want_ids) or ids != want_ids[:len(ids)] \
                or kinds[-1] != "error" or "done" in kinds \
                or events[-1]["data"]["code"] != "ENGINE_FAULT" \
                or svc.stats()["robustness"]["retries"] != 0:
            fail(f"stream fault: events {kinds}, {len(ids)} ids, "
                 f"{svc.stats()['robustness']}")
        log(f"  b. a stream faulted after {len(ids)} tokens (equal to the "
            f"contiguous engine's): terminal ENGINE_FAULT event, no done, "
            f"no retry{at()}")

    def kill():
        """A kill at tick 0, after that tick's prefills launched: the
        watchdog starts a new worker, which drops the unread first tokens,
        quarantines, resets the engine and retries; two more jobs queue
        behind the batch. 4c.h's count runs throughout."""
        binds, resets = [], []
        bind = GenerationEngine.bind_thread

        def traced_bind(self):
            bind(self)
            binds.append((threading.current_thread().name,
                          torch.cuda.current_device(),
                          torch.cuda.current_stream().cuda_stream))
        GenerationEngine.bind_thread = traced_bind
        try:
            dep, svc, eng = redeploy(
                {"faults": {"script": [{"tick": 0, "site": "kill"}]}})
            reset = eng.reset

            def traced_reset():
                resets.append(threading.current_thread().name)
                reset()
            eng.reset = traced_reset
            counter = SyncCounter()
            with counter:
                jobs = [(submit_job(url, inp, f"k{i}"), i)
                        for i, inp in enumerate(greedy_inputs)]
                jobs += [(submit_job(url, greedy_inputs[i], f"q{i}"), i)
                         for i in (0, 1)]
                wait_until(lambda: all(
                    job_state(url, j)["state"] not in ("queued", "running")
                    for j, _ in jobs), "the jobs after the kill")
                for j, i in jobs:
                    job = job_state(url, j)
                    if job["state"] != "done" or job["result"][
                            "predictions"] != contiguous_outs[i]["predictions"]:
                        fail(f"kill: job {j} ({job['state']}) differs from "
                             f"phase 3's tokens: {job}")
                code, health = http(url, "GET", "/v2/health")
                h = health["deployments"]["qwen3-4b"]
                if code != 200 or h["worker_restarts"] != 1 \
                        or not h["worker_alive"]:
                    fail(f"kill: /v2/health answered {code} {health}")
                tick_lane = scheduler_ticks(url)
            del eng.reset
        finally:
            GenerationEngine.bind_thread = bind
        ss = svc.scheduler.stats
        worker = f"batched-{svc.model_id}"
        chunk_ticks = sum(e["args"]["chunk_k"] > 0 for e in tick_lane)
        others = {k: v for k, v in (counter.reads + counter.syncs).items()
                  if k not in (worker, "MainThread")}
        rob = svc.stats()["robustness"]
        log(f"  c. kill at tick 0: worker respawned "
            f"({rob['worker_restarts']}), {rob['engine_faults']} quarantined "
            f"and {rob['retries']} retried; {len(jobs)} jobs done with phase "
            f"3's tokens; after it {ss.ticks} ticks ({chunk_ticks} with a "
            f"chunk), {ss.chunks} chunks, {ss.host_reads} host reads; on the "
            f"worker {counter.reads[worker]} explicit reads and "
            f"{counter.syncs[worker]} synchronizing operations; reset on "
            f"{resets}; worker device and stream {binds}")
        if not (ss.host_reads == chunk_ticks == ss.chunks
                and counter.reads[worker] == ss.host_reads
                and counter.syncs[worker] == ss.host_reads):
            for (name, where), n in counter.where.most_common():
                log(f"    {n} synchronizing operations on {name} at {where}")
            fail("kill: the scheduler read the device more than once a tick")
        if others:
            fail(f"kill: threads other than the worker touched the device: "
                 f"{others}")
        if resets != [worker] or len(binds) != 2 \
                or {b[0] for b in binds} != {worker} \
                or binds[0][1:] != binds[1][1:]:
            fail(f"kill: recovery off the worker or on another device or "
                 f"stream: resets {resets}, binds {binds}")
        if rob["engine_faults"] == 0 \
                or rob["retries"] != rob["engine_faults"]:
            fail(f"kill: {rob}")
        check_pool(dep, "c. after the kill")
        log(f"  c. {ss.host_reads} host reads for {chunk_ticks} chunk ticks, "
            f"none off the worker; the watchdog thread touched no "
            f"tensor{at()}")

    def rebuild():
        """Three scripted chunk faults in a row rebuild the engine
        (rebuild_after_faults 3); its device memory returns to its
        level."""
        dep, svc, eng = redeploy(
            {"faults": {"script": [{"tick": t, "site": "chunk"}
                                   for t in (1, 2, 3)]}},
            max_retries=CHAOS_RETRIES, retry_backoff_s=CHAOS_BACKOFF_S)
        mem = {}
        reset = eng.reset

        def measured_reset():
            torch.cuda.reset_peak_memory_stats()
            mem["before"] = torch.cuda.memory_allocated()
            reset()
            mem["after"] = torch.cuda.memory_allocated()
            mem["peak"] = torch.cuda.max_memory_allocated()
        eng.reset = measured_reset
        code, out = http(url, "POST", "/v2/model/qwen3-4b/predict",
                         {"input": greedy_inputs[0]})
        del eng.reset
        rob = svc.stats()["robustness"]
        if code != 200 \
                or out["predictions"] != contiguous_outs[0]["predictions"]:
            fail(f"rebuild: the retried request differs from phase 3's: "
                 f"{out}")
        if rob["engine_rebuilds"] != 1 or rob["engine_faults"] != 3 \
                or rob["retries"] != 3 or not mem:
            fail(f"rebuild: {rob}, memory {mem}")
        grew = mem["after"] - mem["before"]
        if abs(grew) > PAGE_BYTES:
            fail(f"rebuild: memory_allocated moved {grew} B, over one page "
                 f"({PAGE_BYTES} B)")
        code, out = http(url, "POST", "/v2/model/qwen3-4b/predict",
                         {"input": greedy_inputs[1]})
        if code != 200 \
                or out["predictions"] != contiguous_outs[1]["predictions"]:
            fail(f"rebuild: the next request differs from phase 3's: {out}")
        check_pool(dep, "d. after the rebuild")
        log(f"  d. 3 faults in a row: 1 rebuild, 3 retries, tokens equal "
            f"phase 3's before and after; memory_allocated "
            f"{mem['before'] / 1e9:.3f} GB before the reset, "
            f"{mem['after'] / 1e9:.3f} GB after ({grew:+d} B; a page is "
            f"{PAGE_BYTES} B), peak during it {mem['peak'] / 1e9:.3f} GB "
            f"({mem['peak'] - mem['before']:+d} B) [{card}]{at()}")

    def brownout():
        """HARD closes the circuit and /v2/health answers 503, SOFT sheds
        best_effort and clamps, and the released force reads 200 again."""
        dep, svc, _ = redeploy({"brownout": {"retry_after_s": 2.0,
                                             "clamp_tokens": 4}})
        ctl = svc._brownout
        code, health = http(url, "GET", "/v2/health")
        if code != 200 or not health["ready"]:
            fail(f"brownout: /v2/health before the force: {code} {health}")
        ctl.force("hard")
        code, health, hdrs = http(url, "GET", "/v2/health",
                                  with_headers=True)
        if code != 503 or health["ready"] or not hdrs.get("Retry-After") \
                or health["deployments"]["qwen3-4b"]["degradation"] \
                != "hard":
            fail(f"brownout HARD: /v2/health answered {code} {health} "
                 f"{hdrs}")
        code, out, hdrs = http(url, "POST", "/v2/model/qwen3-4b/predict",
                               {"input": greedy_inputs[0]},
                               with_headers=True)
        if code != 503 or out["error"]["code"] != "CIRCUIT_OPEN" \
                or hdrs.get("Retry-After") != "2":
            fail(f"brownout HARD: predict answered {code} {out} {hdrs}")
        ctl.force("soft")
        code, out, hdrs = http(url, "POST", "/v2/model/qwen3-4b/predict",
                               {"input": greedy_inputs[0],
                                "priority": "best_effort"},
                               with_headers=True)
        if code != 503 or out["error"]["code"] != "DEGRADED" \
                or hdrs.get("Retry-After") != "2":
            fail(f"brownout SOFT: best_effort answered {code} {out} {hdrs}")
        code, out = http(url, "POST", "/v2/model/qwen3-4b/predict",
                         {"input": greedy_inputs[0]})
        pred = out["predictions"][0] if code == 200 else {}
        if pred.get("generated_tokens") != 4 or pred.get("generated_text") \
                != TOKENIZER.decode(contiguous_ids[0][:4]):
            fail(f"brownout SOFT: the clamped predict answered {code} {out}")
        ctl.force("normal")
        ctl.force(None)
        code, health = http(url, "GET", "/v2/health")
        if code != 200 or not health["ready"]:
            fail(f"brownout released: /v2/health answered {code} {health}")
        shed = svc.stats()["robustness"]["brownout"]["shed"]
        check_pool(dep, "e. after brownout")
        log(f"  e. HARD: /v2/health 503 with Retry-After, predict 503 "
            f"CIRCUIT_OPEN (Retry-After 2); SOFT: best_effort 503 DEGRADED, "
            f"{greedy_inputs[0]['max_new_tokens']} tokens asked, 4 given "
            f"(phase 3's first 4); released: 200; {shed} shed{at()}")

    twin, wall_twin, tick_twin = twin_run()
    chaos_run(twin, wall_twin, tick_twin)
    scripted(twin)
    stream_fault()
    kill()
    rebuild()
    brownout()
    tally()
    steps, prefills = totals["steps"], totals["prefills"]
    paged, flash = paged_decode_attention.launches, flash_attention.launches
    if decode_attention.launches != 0 or paged != L * steps \
            or flash != L * prefills or steps == 0:
        fail(f"4d launches: paged {paged} for {steps} steps, flash {flash} "
             f"for {prefills} prefills, contiguous "
             f"{decode_attention.launches}")
    log(f"  launches: paged {paged} ({steps} decode and fill steps x {L}), "
        f"flash {flash} ({prefills} prefills x {L}), contiguous 0")
    log(f"  device memory after each of the {len(levels)} deploys: "
        f"{', '.join(f'{m / 1e9:.2f}' for m in levels)} GB")
    log(f"  phase 4d took {time.perf_counter() - t_phase:.1f} s")
    return {"paged_decode_attention": paged, "decode_attention": 0,
            "flash_attention": flash}


# ---------------------------------------------------------------------------
# phases 5-6: the recurrent families over HTTP, one on the card at a time
# ---------------------------------------------------------------------------

def ring_kernel_counts(cfg):
    """Launches of each kernel one prefill of ``cfg`` makes: an RG-LRU
    scan per recurrent layer (pattern blocks and tail) and a flash per
    local-attention layer for the hybrid; a WKV scan per layer for the
    SSM. Decode makes none."""
    if cfg.family == "ssm":
        return {"wkv_scan": cfg.num_layers}
    n_attn = cfg.num_pattern_blocks * sum(k == "attn"
                                          for k in cfg.block_pattern)
    return {"rglru_scan": cfg.num_layers - n_attn, "flash_attention": n_attn}


def check_against_forward(wrapper, inputs, emitted, label):
    """Every greedy token ``wrapper`` emitted for ``inputs`` (ids in
    ``emitted``, keyed by prompt length) must be the argmax of the model's
    scoring forward over the same prompt (left-padded to its bucket, as a
    ring engine prefills it) plus the tokens before it, up to a margin of
    0.2 x the std of that position's logits. The forward runs the prefill
    kernels over the whole sequence on f32 K/V and states; the served
    tokens came from decode steps (a bf16 cache or ring, the O(1) state
    updates), so only a near-tie may flip. One request at a time, keeping
    only the generated positions' logits. Launches made here are outside
    the main-path counts."""
    import torch
    from repro_torch.serving.engine import _bucket
    V, dev = wrapper.cfg.vocab_size, wrapper.engine.device
    worst, argmax_equal, total = 0.0, 0, 0
    for inp in inputs:
        prompt = wrapper.prepare_generation(inp)[0]
        out = emitted.get(len(prompt))
        if not out:
            fail(f"no tokens recorded for the {len(prompt)}-token prompt")
        start = _bucket(len(prompt)) if wrapper.engine._ring else len(prompt)
        seq = [0] * (start - len(prompt)) + prompt + out[:-1]
        with torch.no_grad():
            ref = wrapper.model.forward(
                wrapper.params, {"tokens": torch.tensor([seq], device=dev)})
            ref = ref[0, start - 1:, :V].clone()
        if not torch.isfinite(ref).all():
            fail("the scoring forward gave non-finite logits")
        tok = torch.tensor(out, device=dev)
        gap = (ref.max(dim=-1).values - ref.gather(1, tok[:, None])[:, 0])
        rel = (gap / ref.std(dim=-1)).max().item()
        worst = max(worst, rel)
        argmax_equal += int((gap == 0).sum())
        total += len(out)
        del ref
        if rel > 0.2:
            fail(f"a greedy {label} request emitted a token {rel:.3f} std "
                 f"below the scoring forward's argmax (margin 0.2)")
    log(f"  {label} vs the scoring forward: {argmax_equal} of {total} "
        f"greedy tokens are the forward's argmax; the largest gap to it is "
        f"{worst:.4f} std (margin 0.2 std)")


def check_decode_logits(wrapper, inp, emitted, tol=0.05):
    """The decode step's logits against the scoring forward's, position
    by position: the request's left-padded prompt is prefilled at B=1 and
    its emitted tokens are fed back through ``decode_step`` (the O(1)
    recurrent updates, the ring attention), and each position's logits
    must lie within ``tol`` x the std of the forward's (the forward runs
    the prefill kernels over the whole sequence). This holds the step path
    to the kernels' path on the logits, where a random model's argmax
    alone could hide a fault."""
    import torch
    from repro_torch.serving.engine import _bucket
    model, params, eng = wrapper.model, wrapper.params, wrapper.engine
    V, dev = wrapper.cfg.vocab_size, eng.device
    prompt = wrapper.prepare_generation(inp)[0]
    out = emitted[len(prompt)]
    bucket = _bucket(len(prompt))
    toks = [0] * (bucket - len(prompt)) + prompt
    with torch.no_grad():
        ref = model.forward(params, {"tokens": torch.tensor(
            [toks + out[:-1]], device=dev)})[0, bucket - 1:, :V].clone()
        logits, cache = model.prefill(
            params, {"tokens": torch.tensor([toks], device=dev)},
            cache_len=eng.max_seq)
        rows = [logits[0, :V]]
        for t in out[:-1]:
            logits, cache = model.decode_step(
                params, cache, torch.tensor([t], dtype=torch.int32,
                                            device=dev))
            rows.append(logits[0, :V])
    err = ((torch.stack(rows) - ref).abs().max(dim=-1).values
           / ref.std(dim=-1)).max().item()
    del ref, cache
    log(f"  {len(prompt)}-token prompt + {len(out) - 1} decode steps at "
        f"B=1: logits within {err:.4f} std of the scoring forward's "
        f"(tolerance {tol} std)")
    if not err <= tol:
        fail(f"decode-step logits differ from the forward's by {err:.3f} "
             f"std (tolerance {tol})")


def phase_ring(server, name, number):
    """Deploy full-width ``name`` over HTTP (max_batch 4, max_seq 4096),
    serve four greedy v2 predicts of 5-1501 tokens and one v1 predict
    sampled at 0.8, all at once; check launches, co-batched == alone, the
    scoring forward's argmax; profile a decode step; undeploy. Returns the
    served run's launches by kernel, and ``rglru_scan``'s by shape."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.kernels.rwkv6 import wkv_scan

    from repro_torch.configs import get_config

    log(f"== phase {number}: {name} over HTTP (ring family)")
    # the CPU sums the scans in another order, and its SSM prefill takes
    # the chunked WKV (a reassociation): logits within 1e-3
    hybrid = get_config(name).family == "hybrid"
    check_small_reference(name, max_seq=256, lengths=(3, 17, 100),
                          new_tokens=40, tol=1e-3,
                          note=" (the 101-token prompt's decode wraps the "
                               "128-entry ring)" if hybrid else "")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    code, env = http(server.url, "POST", f"/v2/model/{name}/deploy",
                     {"paged": True})
    if code != 200 or env.get("status") != "ok" or env["kv_cache"]["paged"]:
        fail(f"deploy {name} failed or paged a ring family: {code} {env}")
    dep = server.manager.get(name)
    wrapper, eng, svc = dep.wrapper, dep.wrapper.engine, dep.service
    cfg = wrapper.cfg
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(wrapper.params))
    log(f"  deployed full-width {name} ({{\"paged\": true}} keeps the ring "
        f"layout, as in the JAX engine): {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.2f} B f32 parameters, in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB; kv_cache "
        f"{json.dumps(env['kv_cache'])}")

    greedy = [{"text": _text(n, i), "max_new_tokens": 48}
              for i, n in enumerate((4, 60, 300, 1500))]
    sampled = {"text": _text(30, 9), "max_new_tokens": 24, "temperature": 0.8}
    requests = [("v2", g) for g in greedy] + [("v1", sampled)]
    if len({len(wrapper.prepare_generation(r[1])[0]) for r in requests}) \
            != len(requests):
        fail("prompt lengths must differ: emitted tokens are keyed by them")
    emitted, fmt = {}, wrapper.format_generation
    wrapper.format_generation = lambda toks, n: (
        emitted.setdefault(n, list(toks)), fmt(toks, n))[1]
    kernels = (rglru_scan, wkv_scan, flash_attention, decode_attention,
               paged_decode_attention)
    for k in kernels:
        k.launches = 0
    rglru_scan.launches_at.clear()
    s0, p0 = eng.steps_dispatched, eng.prefills_dispatched
    outs, wall = predict_all(server.url, name, requests)
    launches = {k.__name__: k.launches for k in kernels}
    rglru_at = dict(rglru_scan.launches_at)
    steps = eng.steps_dispatched - s0
    prefills = eng.prefills_dispatched - p0
    del wrapper.format_generation
    stats = svc.stats()

    for (route, inp), env in zip(requests, outs):
        pred = env["predictions"][0]
        log(f"  {route} prompt {pred['prompt_tokens']:4d} tokens, temperature "
            f"{inp.get('temperature', 0.0)}: {pred['generated_tokens']} "
            f"tokens")
    want = {k: n * prefills for k, n in ring_kernel_counts(cfg).items()}
    for k in kernels:
        if launches[k.__name__] != want.get(k.__name__, 0):
            fail(f"{k.__name__} launches {launches[k.__name__]} != "
                 f"{want.get(k.__name__, 0)} ({prefills} prefills, {steps} "
                 "decode steps)")
    if prefills != len(requests) or steps == 0:
        fail(f"{prefills} prefills and {steps} decode steps for "
             f"{len(requests)} requests")
    if stats["max_batch_seen"] < 2:
        fail(f"no decode batch was shared: {stats['max_batch_seen']}")
    toks = sum(e["predictions"][0]["generated_tokens"] for e in outs)
    log(f"  {len(requests)} concurrent requests (4 v2 greedy, 1 v1 "
        f"sampled), {toks} tokens in {wall:.2f} s ({toks / wall:.1f} "
        f"tokens/s end to end); mean batch {stats['mean_batch_size']}, max "
        f"{stats['max_batch_seen']}; {ttft_text(stats)}")
    log(f"  launches: " + ", ".join(f"{k} {n}" for k, n in launches.items())
        + f" ({prefills} prefills, {steps} decode steps; per prefill "
        f"{json.dumps(ring_kernel_counts(cfg))}, none in decode)")
    # rglru_scan by shape (the wrapper's own count)
    if sum(rglru_at.values()) != launches["rglru_scan"]:
        fail(f"rglru_scan launches by shape {rglru_at} do not add up to "
             f"{launches['rglru_scan']}")
    for shape, n in sorted(rglru_at.items(), key=lambda i: i[0][1]):
        log(f"  rglru_scan a/b [{shape[0]},{shape[1]},{shape[2]}]: {n} "
            "launches")

    # greedy outputs are independent of the co-batch: each greedy request
    # alone over HTTP gives the same tokens
    for inp, env in zip(greedy, outs):
        (alone,), _ = predict_all(server.url, name, [("v2", inp)])
        if alone["predictions"] != env["predictions"]:
            fail("co-batched greedy output differs from the same request "
                 "served alone")
    log("  co-batched greedy outputs equal the same requests served alone")
    check_against_forward(wrapper, greedy, emitted, name)
    for inp in greedy[2:]:       # 301 and 1,501 tokens (a wrapped ring)
        check_decode_logits(wrapper, inp, emitted)
    profile_decode(eng, name)
    eng.reset()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # drop every reference to the model (``fmt`` is a bound method of the
    # wrapper) so the undeploy frees its weights before the next family
    dep = wrapper = eng = svc = fmt = None
    code, _ = http(server.url, "DELETE", f"/v2/model/{name}")
    if code != 200:
        fail(f"undeploy {name} failed: {code}")
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    log(f"  {name}: peak device memory {peak:.1f} GB "
        f"(torch.cuda.max_memory_allocated); after undeploy {left:.2f} GB "
        "allocated")
    if left > 1.0:
        fail(f"undeploying {name} left {left:.1f} GB allocated")
    return launches, rglru_at


# ---------------------------------------------------------------------------
# phase 8: the MoE family over HTTP, at full width and cut depth
# ---------------------------------------------------------------------------

MOE_NAME = "phi3.5-moe-42b-a6.6b"
# every published width, 8 of the 32 layers: 10.67 B f32 parameters (42.7
# GB). All 32 are 41.9 B (167.5 GB in f32, 83.7 GB in bf16): no single
# 80 GB card holds them, and the port has no sharding yet.
MOE_LAYERS = 8
MOE_MAX_SEQ, MOE_MAX_BATCH = 2048, 4


# a router near-tie: the k-th and (k+1)-th router logits of a token closer
# than this. Decode reads the bf16 cache where the forward has f32 K/V,
# which moves router logits by about a hundredth; a routing difference at
# a wider margin than this is a fault, not rounding
NEAR_TIE = 0.1


class RouteRecorder:
    """While entered, wraps ``models.moe.moe_apply`` (the transformer calls
    it through the module) and recomputes each call's routing from its
    router on the device: per call, the tokens T, the capacity C, the
    top-k experts of each token ([T, K], ascending), the margin between
    its k-th and (k+1)-th router logits ([T]) and which assignment
    (token-major, k-minor) went to the sink. Only device tensors are kept,
    so the served path gains no host sync."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.apply, self.calls = moe, moe.moe_apply, []

    def __enter__(self):
        import torch
        moe, apply, calls = self.moe, self.apply, self.calls

        def recorded(params, x, cfg, **kw):
            T = x.shape[0] * x.shape[1]
            E, K = cfg.num_experts, cfg.num_experts_per_tok
            C = moe.capacity(T, E, K, kw.get("capacity_factor")
                             or cfg.moe_capacity_factor)
            logits = x.reshape(T, -1).float() @ params["w_router"]
            top_i = torch.topk(torch.softmax(logits, dim=-1), K, dim=-1,
                               sorted=True).indices
            near = torch.topk(logits, min(K + 1, E), dim=-1).values
            calls.append((T, C, top_i.sort(dim=-1).values,
                          moe.dispatch_slots(top_i, E, C) == E * C,
                          near[:, K - 1] - near[:, -1]))
            return apply(params, x, cfg, **kw)
        moe.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.apply

    def by_layer(self, calls, num_layers, field=2):
        """Consecutive calls (one model pass each ``num_layers``) -> one
        recorded field stacked [num_layers, passes, ...]: 2 the experts
        [T, K], 3 the sinks [T*K], 4 the near-tie margins [T]."""
        import torch
        if len(calls) % num_layers:
            fail(f"{len(calls)} MoE calls are not whole passes of "
                 f"{num_layers} layers")
        out = torch.stack([c[field] for c in calls])
        return out.view(-1, num_layers, *out.shape[1:]).transpose(0, 1)


def first_route_difference(route, fwd, margin):
    """(first position at which a routing ``route`` [L, S, K] (ascending
    experts) differs from the forward's ``fwd`` in any layer, the widest
    forward router margin among the layers that differ there): (S, None)
    when they agree throughout. Fails unless every layer that differs was
    a near-tie in the forward (``margin`` [L, S] < ``NEAR_TIE``)."""
    differs = (route != fwd).any(dim=-1)                         # [L, S]
    if not bool(differs.any()):
        return route.shape[1], None
    pos = int(differs.any(dim=0).nonzero()[0])
    widest = margin[differs[:, pos], pos].max().item()
    if widest >= NEAR_TIE:
        fail(f"the routing differs from the forward's at position {pos} "
             f"where the forward's router margin is {widest:.3f} (a "
             f"near-tie is < {NEAR_TIE})")
    return pos, widest


def _routing(pos, length, margin):
    if margin is None:
        return f"routing equal to the forward's at all {length} positions"
    return (f"routing first differs from the forward's at position {pos} "
            f"of {length} (a near-tie there: margin {margin:.4f})")


def forward_routes(model, params, tokens):
    """(logits [S, V_padded], experts [L, S, K], near-tie margins [L, S])
    of ``model``'s forward over ``tokens``."""
    import torch
    L = model.cfg.num_layers
    with RouteRecorder() as rec, torch.no_grad():
        logits = model.forward(params, {"tokens": tokens[None]})[0]
    return (logits, rec.by_layer(rec.calls, L)[:, 0],
            rec.by_layer(rec.calls, L, field=4)[:, 0])


def check_moe_against_forward(wrapper, model, prompt, out, route):
    """Every greedy token the served MoE request emitted (``out``) against
    ``model``'s forward over the same sequence, through the last position
    before the served path's routing (``route`` [L, S, K]: the experts of
    each position in each layer) first differs from the forward's. Past
    that point the two are different functions: a bf16 KV value (decode
    reads the cache, the forward f32 K/V) can move a router near-tie to
    the other expert. Returns (tokens held, tokens)."""
    import torch
    V, dev = wrapper.cfg.vocab_size, wrapper.engine.device
    seq = torch.tensor(prompt + out[:-1], device=dev)
    ref, fwd, margin = forward_routes(model, wrapper.params, seq)
    if not torch.isfinite(ref).all():
        fail("the scoring forward gave non-finite logits")
    n = len(prompt)
    same, tie = first_route_difference(route[:, :len(seq)], fwd, margin)
    held = max(0, min(len(out), same - (n - 1)))
    ref = ref[n - 1:n - 1 + held, :V]
    gap = ref.max(dim=-1).values - ref.gather(
        1, torch.tensor(out[:held], device=dev)[:, None])[:, 0]
    rel = (gap / ref.std(dim=-1)).max().item() if held else 0.0
    log(f"  {n}-token request vs the dropless forward: "
        f"{_routing(same, len(seq), tie)}; {held} of {len(out)} greedy "
        f"tokens held, "
        f"{int((gap == 0).sum())} the forward's argmax, largest gap "
        f"{rel:.4f} std (margin 0.2)")
    if rel > 0.2:
        fail(f"a greedy MoE request emitted a token {rel:.3f} std below "
             f"the scoring forward's argmax before any routing difference")
    return held, len(out)


def check_moe_decode_logits(wrapper, model, inp, emitted, tol=0.05):
    """``check_decode_logits`` for MoE with the routing recorded on both
    sides: the prompt is prefilled at B=1 and its emitted tokens fed back
    through ``decode_step`` (the decode kernel, ``gmm`` at C = 8), and each
    position's logits must lie within ``tol`` x the std of the forward's
    through the last position before the decode path's routing first
    differs from the forward's."""
    import torch
    params, eng = wrapper.params, wrapper.engine
    V, dev, L = wrapper.cfg.vocab_size, eng.device, model.cfg.num_layers
    prompt = wrapper.prepare_generation(inp)[0]
    out = emitted[len(prompt)]
    n = len(prompt)
    with RouteRecorder() as rec, torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.tensor([prompt], device=dev)},
            cache_len=eng.max_seq)
        rows = [logits[0, :V]]
        for t in out[:-1]:
            logits, cache = model.decode_step(
                params, cache, torch.tensor([t], dtype=torch.int32,
                                            device=dev))
            rows.append(logits[0, :V])
    pre = rec.by_layer(rec.calls[:L], L)[:, 0]
    dec = rec.by_layer(rec.calls[L:], L)[:, :, 0]
    route = torch.cat([pre, dec], dim=1)
    del cache
    ref, fwd, margin = forward_routes(model, params, torch.tensor(
        prompt + out[:-1], device=dev))
    same, tie = first_route_difference(route, fwd, margin)
    held = max(0, min(len(rows), same - (n - 1)))
    ref = ref[n - 1:n - 1 + held, :V]
    err = ((torch.stack(rows[:held]) - ref).abs().max(dim=-1).values
           / ref.std(dim=-1)).max().item() if held else 0.0
    log(f"  {n}-token prompt + {len(out) - 1} decode steps at B=1: "
        f"{_routing(same, n + len(out) - 1, tie)}; logits of {held} of "
        f"{len(rows)} positions within {err:.4f} std of the forward's "
        f"(tolerance {tol} std)")
    if held == 0:
        fail("the prefill's last position already routes differently "
             "from the forward's")
    if not err <= tol:
        fail(f"decode-step logits differ from the forward's by {err:.3f} "
             f"std (tolerance {tol})")


def phase_moe(gmm_checked):
    """Deploy full-width Phi-3.5-MoE at ``MOE_LAYERS`` layers over HTTP
    with the paged pool and the prefix cache (max_batch 4, max_seq 2048);
    serve four greedy v2 predicts of 5-1501 tokens and one v1 predict
    sampled at 0.8 at once, then each greedy request alone (a warm replay
    from its cached pages); check the launches (3 ``gmm`` per layer per
    prefill and per decode or fill step, each at a shape phase 2c checked,
    ``gmm_checked``), co-batched == alone, the pool, and the dropped
    assignments of each served prefill (its routing recorded in a replay
    of the same prefill call, so the timed traffic is not instrumented);
    hold the greedy
    tokens to a dropless scoring forward where the prefill dropped no real
    token's assignment, through the routing they share; profile a decode
    step; undeploy."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.api import MAXServer
    from repro_torch.core.assets import _make_asset
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gmm import gmm
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.kernels.rwkv6 import wkv_scan
    from repro_torch.models import build_model
    from repro_torch.serving.engine import _bucket

    log("== phase 8: the MoE family over HTTP (paged pool, prefix cache)")
    # the contiguous engine (decode_attention) on MoE, GPU kernels vs the
    # CPU's plain versions; routing and drops are the same on both
    for name in (MOE_NAME, "qwen3-moe-235b-a22b"):
        check_small_reference(name, max_seq=256, lengths=(3, 17, 100),
                              new_tokens=40, tol=1e-4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    cfg = get_config(MOE_NAME).replace(num_layers=MOE_LAYERS)
    registry = ModelRegistry()
    registry.register(_make_asset(cfg))
    server = MAXServer(registry=registry,
                       build_kw={"smoke": False, "max_seq": MOE_MAX_SEQ,
                                 "max_batch": MOE_MAX_BATCH},
                       service_kw={"batch_window_s": 0.05}).start()
    try:
        t0 = time.perf_counter()
        code, env = http(server.url, "POST", f"/v2/model/{MOE_NAME}/deploy",
                         {"paged": True, "prefix_cache": True})
        if code != 200 or env.get("status") != "ok":
            fail(f"deploy {MOE_NAME} failed: {code} {env}")
        kv = env["kv_cache"]
        if not kv["paged"] or kv["pool_blocks"] != 512 \
                or kv["page_size"] != 16:
            fail(f"the MoE deploy did not give the 512 x 16 pool: {kv}")
        dep = server.manager.get(MOE_NAME)
        wrapper, eng, svc = dep.wrapper, dep.wrapper.engine, dep.service
        L, B, P = cfg.num_layers, eng.max_batch, eng.page_size
        K = cfg.num_experts_per_tok
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(wrapper.params))
        log(f"  deployed {MOE_NAME} at every published width and "
            f"{L} of 32 layers ({cfg.num_experts} experts of d_ff "
            f"{cfg.d_ff}, top-{K}): {n_params / 1e9:.2f} B f32 parameters, "
            f"in {time.perf_counter() - t0:.1f} s; device memory "
            f"{torch.cuda.memory_allocated() / 1e9:.1f} GB; pool "
            f"{kv['pool_blocks']} pages of {kv['page_size']} tokens, "
            f"{kv['kv_bytes_per_token']} B per token")

        greedy = [{"text": _text(n, i), "max_new_tokens": 48}
                  for i, n in enumerate((4, 60, 300, 1500))]
        sampled = {"text": _text(30, 9), "max_new_tokens": 24,
                   "temperature": 0.8}
        requests = [("v2", g) for g in greedy] + [("v1", sampled)]
        prompts = [wrapper.prepare_generation(r[1])[0] for r in requests]
        if len({len(p) for p in prompts}) != len(prompts):
            fail("prompt lengths must differ: emitted tokens are keyed by "
                 "them")
        emitted, fmt = {}, wrapper.format_generation
        wrapper.format_generation = lambda toks, n: (
            emitted.setdefault(n, list(toks)), fmt(toks, n))[1]
        kernels = (gmm, flash_attention, paged_decode_attention,
                   decode_attention, rglru_scan, wkv_scan)
        for k in kernels:
            k.launches = 0
        gmm.launches_at.clear()
        s0, p0 = eng.steps_dispatched, eng.prefills_dispatched
        outs, wall = predict_all(server.url, MOE_NAME, requests)
        launches = {k.__name__: k.launches for k in kernels}
        gmm_at = dict(gmm.launches_at)
        steps = eng.steps_dispatched - s0
        prefills = eng.prefills_dispatched - p0
        stats = svc.stats()

        for (route, inp), env in zip(requests, outs):
            pred = env["predictions"][0]
            log(f"  {route} prompt {pred['prompt_tokens']:4d} tokens, "
                f"temperature {inp.get('temperature', 0.0)}: "
                f"{pred['generated_tokens']} tokens")
        want = {"gmm": 3 * L * (prefills + steps),
                "flash_attention": L * prefills,
                "paged_decode_attention": L * steps}
        for k in kernels:
            if launches[k.__name__] != want.get(k.__name__, 0):
                fail(f"{k.__name__} launches {launches[k.__name__]} != "
                     f"{want.get(k.__name__, 0)} ({prefills} prefills, "
                     f"{steps} decode and fill steps, {L} layers)")
        if steps == 0 or prefills == 0:
            fail(f"{prefills} prefills and {steps} steps for "
                 f"{len(requests)} requests")
        if stats["max_batch_seen"] < 2:
            fail(f"no decode batch was shared: {stats['max_batch_seen']}")
        # gmm by shape (the wrapper's own count): each shape one phase 2c
        # checked, and gate and up twice as many as down at each capacity
        if sum(gmm_at.values()) != launches["gmm"]:
            fail(f"gmm launches by shape {gmm_at} do not add up to "
                 f"{launches['gmm']}")
        for shape, n in sorted(gmm_at.items(), key=lambda i: i[0][1:]):
            E_, C, d_, f_ = shape
            if shape not in gmm_checked:
                fail(f"gmm ran at {shape}, which phase 2c did not check")
            if d_ == cfg.d_model and gmm_at.get((E_, C, f_, d_), 0) * 2 != n:
                fail(f"gmm at capacity {C}: {n} gate/up launches, "
                     f"{gmm_at.get((E_, C, f_, d_), 0)} down")
            log(f"  gmm [{E_},{C},{d_}] @ [{E_},{d_},{f_}] "
                f"({'small-C' if C <= 16 else 'tensor-core'} path): {n} launches")
        toks = sum(e["predictions"][0]["generated_tokens"] for e in outs)
        log(f"  {len(requests)} concurrent requests (4 v2 greedy, 1 v1 "
            f"sampled), {toks} tokens in {wall:.2f} s "
            f"({toks / wall:.1f} tokens/s end to end); mean batch "
            f"{stats['mean_batch_size']}, max {stats['max_batch_seen']}; "
            f"{ttft_text(stats)}")
        log(f"  launches: gmm {launches['gmm']} (3 x {L} layers x "
            f"({prefills} prefills + {steps} decode and fill steps)), flash "
            f"{launches['flash_attention']}, paged decode "
            f"{launches['paged_decode_attention']}, contiguous decode 0")

        # dropped assignments of each served prefill: a cold miss
        # prefills the prompt's page-aligned part, padded to its bucket
        # (pads after the real tokens); the rest goes through decode
        # steps. Its routing is recorded in a replay of the same prefill
        # call (the same tokens, bucket and length through the same
        # deterministic kernels), after the timed traffic above
        served, real, clean = {}, {}, []
        for inp, prompt in zip(greedy + [sampled], prompts):
            n = len(prompt)
            real[n] = (n - 1) // P * P if n - 1 >= P else 0
            if not real[n]:
                log(f"  {n}-token prompt: no prefill (all {n} tokens "
                    "through decode steps): 0 assignments dropped")
                clean.append(inp)
                continue
            T = _bucket(real[n])
            with RouteRecorder() as rec:
                eng._prefill(prompt[:real[n]], T, real[n])
            C = rec.calls[0][1]
            served[n] = rec.by_layer(rec.calls, L)[:, 0]
            sk = rec.by_layer(rec.calls, L, field=3)[:, 0]
            total, lost = int(sk.sum()), int(sk[:, :real[n] * K].sum())
            log(f"  {n}-token prompt: prefill of {real[n]} tokens in a {T} "
                f"bucket, capacity {C} per expert: {total} of "
                f"{L * T * K} assignments dropped over {L} layers, {lost} "
                f"of them real tokens'")
            if lost == 0:
                clean.append(inp)
            del rec, sk
        if len(served) != prefills:
            fail(f"{len(served)} prompts with a cold prefill for "
                 f"{prefills} served prefills")

        # greedy outputs do not depend on the co-batch: each request alone
        # (a warm replay from its cached pages; the tail through the same
        # decode steps, so it computes what its cold run did, drops or
        # not), its routing recorded: slot 0, one position per step
        hit0 = svc.stats()["prefix_cache"]["hit_tokens"]
        alone_routes = {}
        for inp, env, prompt in zip(greedy, outs, prompts):
            n = len(prompt)
            emitted.pop(n)
            with RouteRecorder() as rec:
                (alone,), _ = predict_all(server.url, MOE_NAME,
                                          [("v2", inp)])
            if alone["predictions"] != env["predictions"]:
                fail("co-batched greedy output differs from the same "
                     "request served alone")
            if any(c[0] != B or bool(c[3].any()) for c in rec.calls):
                fail("a warm replay ran a prefill, or a decode or fill step "
                     "dropped an assignment")
            alone_routes[n] = rec.by_layer(rec.calls, L)[:, :, 0]  # slot 0
        del wrapper.format_generation
        hits = svc.stats()["prefix_cache"]["hit_tokens"] - hit0
        if hits < sum(real[len(p)] for p in prompts[:4]):
            fail(f"the replays hit {hits} cached tokens, not every "
                 "aligned prompt page")
        log(f"  co-batched greedy outputs equal the same requests served "
            f"alone, each a warm replay ({hits} prompt tokens from cached "
            f"pages): warm equals cold")
        check_pool(dep, MOE_NAME)

        # the served tokens against a forward that drops nothing (capacity
        # factor E / K: C >= T), for the requests whose prefill dropped no
        # real token's assignment (decode steps never drop), through the
        # positions where the served routing equals the forward's
        dropless = build_model(cfg.replace(
            moe_capacity_factor=cfg.num_experts / K))
        held = total = 0
        for inp, prompt in zip(greedy, prompts):
            n = len(prompt)
            if inp not in clean:
                log(f"  {n}-token request not held to the forward: its "
                    "prefill dropped real tokens' assignments")
                continue
            parts = [alone_routes[n]]
            if real[n]:
                parts.insert(0, served[n][:, :real[n]])
            h, t = check_moe_against_forward(
                wrapper, dropless, prompt, emitted[n],
                torch.cat(parts, dim=1))
            held, total = held + h, total + t
        log(f"  held to the dropless forward: {held} of {total} greedy "
            f"tokens of {sum(g in clean for g in greedy)} of {len(greedy)} "
            "requests")
        for inp in greedy[2:]:       # 301 and 1,501 tokens
            check_moe_decode_logits(wrapper, dropless, inp, emitted)
        del served, alone_routes
        sync_free_paged_chunk(eng)
        profile_decode(eng, f"{MOE_NAME} ({L} layers)")
        eng.reset()
        peak = torch.cuda.max_memory_allocated() / 1e9
        dep = wrapper = eng = svc = fmt = dropless = None
        code, _ = http(server.url, "DELETE", f"/v2/model/{MOE_NAME}")
        if code != 200:
            fail(f"undeploy {MOE_NAME} failed: {code}")
    finally:
        server.stop()
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    log(f"  {MOE_NAME}: peak device memory {peak:.1f} GB "
        f"(torch.cuda.max_memory_allocated); after undeploy {left:.2f} GB "
        "allocated")
    if left > 1.0:
        fail(f"undeploying {MOE_NAME} left {left:.1f} GB allocated")
    return launches, gmm_at


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
    kernels.update(phase_recurrent_kernels())
    gmm_rows = phase_gmm_kernel()
    kernels["gmm"] = gmm_rows[moe_gmm_shapes()[0]]    # a decode's gate/up
    launches, greedy_inputs, greedy_outs, greedy_ids = phase_main_path(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.core.api import MAXServer
    server = MAXServer(build_kw={"smoke": False, "max_seq": 2048,
                                 "max_batch": 4},
                       service_kw={"batch_window_s": 0.05}).start()
    try:
        http_launches = phase_http(cfg, server, greedy_inputs, greedy_outs)
        life = phase_lifecycle(cfg, server, card, greedy_inputs, greedy_outs,
                               greedy_ids)
        robust = phase_robustness(cfg, server, card, greedy_inputs,
                                  greedy_outs, greedy_ids)
    finally:
        server.stop()
    gc.collect()
    torch.cuda.empty_cache()
    launches["paged_decode_attention"] = \
        http_launches["paged_decode_attention"]
    # phases 4c's and 4d's launches join each kernel's total on its path
    for name in life:
        launches[name] += life[name] + robust[name]
    if torch.cuda.memory_allocated() > 1e9:
        fail(f"{torch.cuda.memory_allocated() / 1e9:.1f} GB still allocated "
             "before the recurrent families")
    server = MAXServer(build_kw={"smoke": False, "max_seq": 4096,
                                 "max_batch": 4},
                       service_kw={"batch_window_s": 0.05}).start()
    try:
        hybrid, rglru_at = phase_ring(server, "recurrentgemma-9b", 5)
        ssm, _ = phase_ring(server, "rwkv6-7b", 6)
    finally:
        server.stop()
    launches["rglru_scan"] = hybrid["rglru_scan"]
    launches["wkv_scan"] = ssm["wkv_scan"]
    launches["flash_attention_hd256"] = hybrid["flash_attention"]
    if torch.cuda.memory_allocated() > 1e9:
        fail(f"{torch.cuda.memory_allocated() / 1e9:.1f} GB still allocated "
             "before the MoE family")
    moe, gmm_at = phase_moe(gmm_rows)
    launches["gmm"] = moe["gmm"]

    sources = {
        "flash_attention": ("flash_attention",
                            "src/repro/kernels/flash_attention.py:76"),
        "decode_attention": ("decode_attention",
                             "src/repro/kernels/decode_attention.py:195"),
        "paged_decode_attention": ("decode_attention",
                                   "src/repro/kernels/decode_attention.py:138"),
        "rglru_scan": ("rglru", "src/repro/kernels/rglru.py:52"),
        "wkv_scan": ("rwkv6", "src/repro/kernels/rwkv6.py:59"),
        "gmm": ("gmm", "src/repro/kernels/gmm.py:37"),
    }

    def row(name, k=None, n=None):
        k = k or kernels[name]
        return {"launches": launches[name] if n is None else n,
                "max_abs_err": k["max_abs_err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k["library_ms"], "library": k["library"],
                "timed_at": k["shape"],
                # gmm: the bound on the CUDA cores alone and the errors
                # against f64; decode: the split decode_splits picked
                # beside the best one swept
                **{key: k[key] for key in ("simt_bound_ms", "f64_err",
                                           "split") if key in k}}

    line = []
    for name, (src, replaces) in sources.items():
        line.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}.cu",
                     "replaces": replaces, **row(name)})
    # the same kernel at hd 256, on the hybrid's path
    line[0]["hd256"] = row("flash_attention_hd256")
    # gmm's row: all its launches on the MoE path, timed at a decode
    # step's gate/up (the shape of most of them); then one row for each
    # shape the path ran it at, with that shape's own launches, error and
    # times
    line[-1]["by_shape"] = [
        row("gmm", gmm_rows[shape], n)
        for shape, n in sorted(gmm_at.items(), key=lambda i: i[0][1:])]
    # rglru_scan's row: each timed shape with the served run's launches at
    # it
    line[list(sources).index("rglru_scan")]["by_shape"] = [
        {**t, "launches": rglru_at.get(tuple(t["shape"]), 0)}
        for t in kernels["rglru_scan"]["by_shape"]]
    log("== phase 7: kernels")
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
