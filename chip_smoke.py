"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, started together) and print the card's name and power
   limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's full-width shapes and at small ones;
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
5. print ``{"kernels": [...]}`` with each kernel's launches on its path,
   its error against the plain version, and its time, the plain version's
   time, the bound and a library call's time, all measured here;
6. print ``{"ok": true, "device": {...}}`` as the last line.

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
    out["paged_decode_attention"] = check_paged(cfg, randn)
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
            (3, 4, 2, 64, 30, 5, 12, torch.float32, (0, 5, 59))):
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
    bound = max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["float32"]) * 1e3
    bound_by = ("bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_FLOPS["float32"]
                else "operations")
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
                shape=f"q [{B},{H},{hd}] f32, pools [{N},{P},{KV},{hd}] bf16, "
                      f"shuffled table [{B},{nb}], lengths 2048 each")


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

    log("== phase 3: contiguous path")
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
    return launches, inputs[:4], outs[:4]


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


def http(url, method, path, payload=None, timeout=600):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url + path, data,
                                 {"Content-Type": "application/json"},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def concurrent_predicts(url, inputs):
    """POST every input to /v2/.../predict at once; (envelopes, wall s)."""
    outs = [None] * len(inputs)
    gate = threading.Barrier(len(inputs))

    def go(i):
        gate.wait(timeout=60)
        outs[i] = http(url, "POST", "/v2/model/qwen3-4b/predict",
                       {"input": inputs[i]})

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(inputs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail("an HTTP request did not return")
    for inp, out in zip(inputs, outs):
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
    clock (submit to the first token's host read)."""
    n0 = len(svc._ttft_s)
    out = fn()
    if len(svc._ttft_s) != n0 + 1:
        fail("a solo request did not record one TTFT")
    return out, svc._ttft_s[-1]


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


def phase_http(cfg, greedy_inputs, contiguous_outs):
    """The HTTP front over the paged pool and the prefix cache, full width:
    every decode and fill step must launch the paged kernel (36 per step)
    and none the contiguous one."""
    import torch
    from repro_torch.core.api import MAXServer
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention

    log("== phase 4: HTTP path (paged KV pool, prefix cache)")
    L = cfg.num_layers
    server = MAXServer(build_kw={"smoke": False, "max_seq": 2048,
                                 "max_batch": 4},
                       service_kw={"batch_window_s": 0.05}).start()
    try:
        paged_decode_attention.launches = 0
        decode_attention.launches = 0
        flash_attention.launches = 0
        steps = prefills = 0

        # 1. paged, no prefix cache: the contiguous phase's greedy requests
        deploy(server.url, {"paged": True})
        dep = server.manager.get("qwen3-4b")
        eng = dep.wrapper.engine
        s0, p0 = eng.steps_dispatched, eng.prefills_dispatched
        outs, wall = concurrent_predicts(server.url, greedy_inputs)
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
        _, ttft_cold = ttft_of_next(svc, lambda: concurrent_predicts(
            server.url, [cold_in]))
        # the token ids each request emitted, as the service hands them to
        # the wrapper's formatter (the envelope carries only their text)
        emitted, fmt = {}, dep.wrapper.format_generation
        dep.wrapper.format_generation = lambda toks, n: (
            emitted.setdefault(n, list(toks)), fmt(toks, n))[1]
        outs, wall = concurrent_predicts(server.url, inputs)
        del dep.wrapper.format_generation
        hits0 = svc.stats()["prefix_cache"]["hit_tokens"]
        (replay, _), ttft_warm = ttft_of_next(svc, lambda: concurrent_predicts(
            server.url, [inputs[0]]))
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
    finally:
        server.stop()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_prefix_reference(dep, inputs, emitted):
    """The prefix path held against a path that shares none of its parts:
    the model's scoring forward over the whole sequence (flash attention on
    f32 K/V; no cache, no pool, no decode kernel).

    - Every greedy token the concurrent prefix requests emitted (three of
      them prefix hits, their fills running beside other slots' decode)
      must be the forward's argmax at its position, up to a margin of
      0.2 x the std of that position's logits: the paths differ by the
      bf16 rounding of the cached K/V, so only a near-tie may flip.
    - A warm admission (64 cached pages by reference, the tail through
      masked paged decode steps) gives first-token logits within
      atol = 0.1 x the std of the forward's logits at the prompt's end.

    Launches made here are outside the main-path counts."""
    import torch
    wrapper, eng = dep.wrapper, dep.wrapper.engine
    V = wrapper.cfg.vocab_size
    worst = 0.0
    argmax_equal = total = 0
    for inp in inputs:
        prompt = wrapper.prepare_generation(inp)[0]
        out = emitted.get(len(prompt))
        if not out:
            fail(f"no tokens recorded for the {len(prompt)}-token prompt")
        seq = torch.tensor([prompt + out[:-1]], device="cuda")
        with torch.no_grad():
            ref = wrapper.model.forward(wrapper.params, {"tokens": seq})
        ref = ref[0, len(prompt) - 1:, :V]
        std = ref.std(dim=-1)
        tok = torch.tensor(out, device="cuda")
        gap = (ref.max(dim=-1).values - ref.gather(1, tok[:, None])[:, 0])
        rel = (gap / std).max().item()
        worst = max(worst, rel)
        argmax_equal += int((gap == 0).sum())
        total += len(out)
        if rel > 0.2:
            fail(f"a greedy prefix request emitted a token {rel:.3f} std "
                 f"below the reference forward's argmax (margin 0.2)")
    log(f"  prefix vs the scoring forward: {argmax_equal} of {total} greedy "
        f"tokens are the reference argmax; the largest gap to it is "
        f"{worst:.4f} std (margin 0.2 std)")

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
    launches, greedy_inputs, greedy_outs = phase_main_path(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    http_launches = phase_http(cfg, greedy_inputs, greedy_outs)
    launches["paged_decode_attention"] = \
        http_launches["paged_decode_attention"]

    sources = {
        "flash_attention": ("flash_attention",
                            "src/repro/kernels/flash_attention.py:76"),
        "decode_attention": ("decode_attention",
                             "src/repro/kernels/decode_attention.py:195"),
        "paged_decode_attention": ("decode_attention",
                                   "src/repro/kernels/decode_attention.py:138"),
    }
    line = []
    for name, (src, replaces) in sources.items():
        k = kernels[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "timed_at": k["shape"]})
    log("== phase 5: kernels")
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
