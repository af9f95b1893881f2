"""Generation engine: bucketed prefill + fused batched decode with slot
management (counterpart of ``repro/serving/engine.py``, contiguous KV
layout only).

The engine owns a fixed-capacity decode batch (``max_batch`` slots, each
with a ``max_seq`` cache). A request is prefilled alone (its prompt
padded to a power-of-two bucket) and *inserted* into a free slot of the
running batch cache — the mechanism continuous batching (scheduler.py)
is built on.

The decode fast path is sync-free. The next input token of each slot
lives on the device (``_next_tok``); ``insert_request`` returns the first
generated token as an unforced 0-d device tensor; ``step_chunk`` runs up
to ``decode_chunk`` decode steps with on-device sampling and per-slot
termination masks (EOS / token budget / ``max_seq`` capacity) and returns
device tensors, which the scheduler reads in one host sync per chunk.
Nothing inside a chunk calls ``.item()``, ``.tolist()``, ``.cpu()`` or
indexes with a boolean mask.

Host inputs (budgets, temperatures, the active mask) cross to the device
through pinned buffers with ``non_blocking=True``, which does not wait for
the device.

The JAX package's paged KV pool and prefix cache are not ported yet:
``paged=True`` / ``prefix_cache=True`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.sampling import gumbel_noise, mask_padded_vocab
from repro_torch.serving.tracing import now as _now


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class GenerationResult:
    tokens: List[int]
    prompt_len: int
    steps: int
    finished: bool
    latency_s: float = 0.0
    # time to first token, measured at the first host sync that revealed
    # one (None on paths that do not time it)
    first_token_s: Optional[float] = None


class GenerationEngine:
    """Single-device serving engine for one model asset."""

    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_seq: int = 512, eos_id: Optional[int] = None,
                 decode_chunk: int = 8, paged: bool = False,
                 prefix_cache: bool = False, device: DeviceLike = "cuda"):
        if paged or prefix_cache:
            raise NotImplementedError(
                "the paged KV pool and the prefix cache (paged=True, "
                "prefix_cache=True) come with the next slice of the PyTorch "
                "port, together with the paged_decode_attention kernel")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        # fused decode steps per host sync, floored to a power of two (the
        # scheduler's budget alignment only ever uses pow2 lengths)
        self.decode_chunk = 1 << (max(1, int(decode_chunk)).bit_length() - 1)
        # decode steps dispatched (each runs every layer once, active or
        # masked) — the count a kernel-launch audit compares against
        self.steps_dispatched = 0
        # A sliding window shorter than max_seq wraps: such engines keep a
        # ring cache and left-pad prompts (pads count as context); a window
        # >= max_seq never wraps, so the cache is plain linear.
        self._ring = (self.cfg.sliding_window is not None
                      and self.cfg.sliding_window < max_seq)
        self.reset()
        self._kv_bytes_per_token = self._bytes_per_token(self._cache)

    @staticmethod
    def _bytes_per_token(cache) -> int:
        """Device bytes one token of context costs across all layers."""
        k = cache["k"]                                  # [L, B, S, KV, hd]
        return 2 * k.shape[0] * k.shape[3] * k.shape[4] * k.element_size()

    def _h2d(self, arr, dtype) -> torch.Tensor:
        """Host array -> fresh device tensor without waiting for the
        device (pinned staging, non-blocking copy)."""
        t = torch.as_tensor(np.array(arr), dtype=dtype)    # a fresh copy
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- device-side pieces --------------------------------------------------

    def _sample(self, logits, generator, temps, any_temp: bool):
        """Per-slot-temperature sampling: rows at 0 take the greedy argmax.
        Noise is drawn only when some slot samples (``any_temp`` is known
        on the host), so greedy batches consume no random numbers."""
        masked = mask_padded_vocab(logits, self.cfg.vocab_size)
        greedy = torch.argmax(masked, dim=-1).to(torch.int32)
        if not any_temp:
            return greedy
        scaled = masked / torch.clamp(temps, min=1e-6)[:, None]
        noise = gumbel_noise(scaled.shape, generator, scaled.device)
        sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
        return torch.where(temps > 0, sampled, greedy)

    def _runnable(self, tok, left, lengths, run):
        """Per-slot continuation mask: a slot keeps decoding while it has
        token budget, cache capacity for the next KV write, and its input
        token is not EOS."""
        run = run & (left > 0) & (lengths < self.max_seq)
        if self.eos_id is not None:
            run = run & (tok != self.eos_id)
        return run

    # -- public API ------------------------------------------------------------

    def fits_prompt(self, n: int) -> bool:
        """Whether an ``n``-token prompt is admissible: its padding bucket
        fits ``max_seq`` and its physical prefill length (the bucket itself
        for ring caches) leaves at least one KV write of headroom."""
        bucket = _bucket(n)
        if bucket > self.max_seq:
            return False
        true_len = bucket if self._ring else n
        return true_len < self.max_seq

    def max_prompt_len(self) -> int:
        """Longest admissible prompt, consistent with :meth:`fits_prompt`."""
        if not self._ring:
            n = self.max_seq - 1
            if n > 0 and _bucket(n) <= self.max_seq:
                return n
        b = 16                       # _bucket's minimum
        if b > self.max_seq or (self._ring and b >= self.max_seq):
            return 0
        limit = self.max_seq - 1 if self._ring else self.max_seq
        while b * 2 <= limit:
            b *= 2
        return b

    def free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch) if not self._active[i]]

    def context_len(self, slot: int) -> int:
        """Physical cache length of ``slot`` (includes ring padding)."""
        return int(self._lengths[slot])

    def active_logical_tokens(self) -> int:
        """Prompt tokens as submitted plus generated tokens, over the
        active slots (ring padding is not billed)."""
        gen = self._lengths - self._prefill_lens
        return int(((self._prompt_lens + gen) * self._active).sum())

    def capacity_left(self, slot: int) -> int:
        """KV writes remaining before ``slot`` cannot decode another token."""
        return max(0, int(self.max_seq - self._lengths[slot]))

    def kv_stats(self) -> Dict[str, Any]:
        """KV memory accounting: a contiguous cache charges the full
        ``max_seq`` per occupied slot."""
        bpt = self._kv_bytes_per_token
        active = int(self._active.sum())
        logical = self.active_logical_tokens()
        in_use = active * self.max_seq * bpt
        return {"paged": False, "active_slots": active,
                "active_tokens": logical, "kv_bytes_per_token": bpt,
                "kv_bytes_in_use": int(in_use),
                "kv_bytes_per_active_token": (round(in_use / logical, 1)
                                              if logical else 0.0)}

    def insert_request(self, prompt: List[int], slot: int) -> torch.Tensor:
        """Prefill ``prompt`` into ``slot``; returns the first generated
        token as an *unforced* 0-d device tensor (greedy argmax over the
        prefill logits). Callers read it at their next sync point."""
        assert not self._active[slot], f"slot {slot} busy"
        bucket = _bucket(len(prompt))
        if bucket > self.max_seq:
            raise ValueError(
                f"prompt {len(prompt)} exceeds max_seq {self.max_seq}")
        # ring caches need contiguous positions, so their prompts are
        # LEFT-padded and pads are context; linear caches RIGHT-pad, causal
        # masking keeps pads out of real tokens' attention and decode
        # masks by the true length
        padded = np.zeros((1, bucket), np.int32)
        if self._ring:
            padded[0, bucket - len(prompt):] = prompt
            true_len = bucket
        else:
            padded[0, :len(prompt)] = prompt
            true_len = len(prompt)
        batch = {"tokens": self._h2d(padded, torch.int32),
                 "prompt_lengths": self._h2d([true_len], torch.int32)}
        # host mirrors flip before the dispatch (stats readers on other
        # threads never see a busy slot without an owner)
        self._lengths[slot] = true_len
        self._prompt_lens[slot] = len(prompt)
        self._prefill_lens[slot] = true_len
        self._active[slot] = True
        try:
            logits, one = self.model.prefill(self.params, batch,
                                             cache_len=self.max_seq)
            # in place into the batch cache (the JAX engine donates it)
            self._cache["k"][:, slot] = one["k"][:, 0]
            self._cache["v"][:, slot] = one["v"][:, 0]
            self._cache["lengths"][slot] = one["lengths"][0]
            masked = mask_padded_vocab(logits[0], self.cfg.vocab_size)
            first = torch.argmax(masked).to(torch.int32)
            self._next_tok[slot] = first
        except Exception:
            self.release_slot(slot)
            raise
        return first

    def release_slot(self, slot: int):
        """Retire ``slot`` (its cache rows are overwritten by the next
        insert)."""
        self._active[slot] = False

    def reset(self):
        """Rebuild every piece of mutable serving state: the KV cache, the
        host length/active mirrors and the device next-token buffer.
        Weights survive; active slots are abandoned."""
        self._cache = self.model.init_cache(self.max_batch, self.max_seq,
                                            device=self.device)
        self._lengths = np.zeros((self.max_batch,), np.int32)
        self._active = np.zeros((self.max_batch,), bool)
        self._prompt_lens = np.zeros((self.max_batch,), np.int32)
        self._prefill_lens = np.zeros((self.max_batch,), np.int32)
        self._next_tok = torch.zeros((self.max_batch,), dtype=torch.int32,
                                     device=self.device)

    def step(self, tokens, generator: Optional[torch.Generator],
             temperature=0.0) -> np.ndarray:
        """One decode step for the whole batch (reads the result on the
        host). tokens [max_batch] int; ``temperature`` is a scalar or a
        per-slot vector. Slots whose cache is full are masked: they emit 0
        and do not advance."""
        writable = self._active & (self._lengths < self.max_seq)
        active = self._h2d(writable, torch.bool)
        temps = np.broadcast_to(np.asarray(temperature, np.float32),
                                (self.max_batch,))
        logits, self._cache = self.model.decode_step(
            self.params, self._cache, self._h2d(tokens, torch.int32),
            active=active)
        self.steps_dispatched += 1
        nxt = self._sample(logits, generator,
                           self._h2d(temps, torch.float32),
                           bool((temps > 0).any()))
        nxt = torch.where(active, nxt, 0)
        self._lengths[writable] += 1
        return nxt.cpu().numpy()

    def step_chunk(self, generator: Optional[torch.Generator], temperature,
                   budgets, k: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dispatch one fused chunk of ``k`` (default ``decode_chunk``)
        decode steps.

        ``budgets`` [max_batch] = tokens each slot may still emit (0 for
        free slots). Input tokens come from the device-resident
        ``_next_tok``. Per step, slots whose mask is off keep their input
        token and do not advance their cache length. Returns unforced
        device tensors ``(tokens [B, k] int32, emitted [B, k] bool)``;
        ``emitted[b]`` is a contiguous prefix mask. The caller reads both
        in ONE host sync and then calls :meth:`commit_chunk`.

        Step ``i`` draws its sampling noise from ``generator`` exactly as
        the ``i``-th of ``k`` single :meth:`step` calls would, so fused and
        stepwise decode agree token for token."""
        k = self.decode_chunk if k is None else max(1, int(k))
        temps = np.broadcast_to(np.asarray(temperature, np.float32),
                                (self.max_batch,))
        any_temp = bool((temps > 0).any())
        temps_d = self._h2d(temps, torch.float32)
        left = self._h2d(np.asarray(budgets, np.int32), torch.int32)
        active = self._h2d(self._active, torch.bool)
        tok = self._next_tok
        run = self._runnable(tok, left, self._cache["lengths"], active)
        toks, emitted = [], []
        for _ in range(k):
            logits, self._cache = self.model.decode_step(
                self.params, self._cache, tok, active=run)
            self.steps_dispatched += 1
            nxt = self._sample(logits, generator, temps_d, any_temp)
            # dead slots hold their token
            nxt = torch.where(run, nxt, tok)
            left = left - run.to(torch.int32)
            toks.append(nxt)
            emitted.append(run)
            run = self._runnable(nxt, left, self._cache["lengths"], run)
            tok = nxt
        self._next_tok = tok
        return torch.stack(toks, dim=1), torch.stack(emitted, dim=1)

    def commit_chunk(self, emitted_counts: np.ndarray):
        """Fold a chunk's per-slot emission counts into the host length
        mirror (each emitted token wrote exactly one KV entry)."""
        self._lengths += np.asarray(emitted_counts, np.int32)

    # -- convenience: synchronous batch generation ------------------------------

    def generate(self, prompts: List[List[int]], *, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0
                 ) -> List[GenerationResult]:
        """Generate for up to ``max_batch`` prompts at once, one host read
        per token (the scheduler drives the slot API for continuous
        batching)."""
        assert len(prompts) <= self.max_batch
        t0 = _now()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        last_tok = np.zeros((self.max_batch,), np.int32)
        outs: List[List[int]] = [[] for _ in prompts]
        try:
            firsts = [self.insert_request(p, i) for i, p in enumerate(prompts)]
        except Exception:
            for i in range(len(prompts)):
                self.release_slot(i)
            raise
        for i, f in enumerate(firsts):            # one deferred sync point
            first = int(f)
            outs[i].append(first)
            last_tok[i] = first
        t_first = _now() - t0
        done = [False] * len(prompts)
        capped = [False] * len(prompts)
        for _ in range(max_new_tokens - 1):
            # a slot at cache capacity cannot decode another token
            for i in range(len(prompts)):
                if not done[i] and self.capacity_left(i) <= 0:
                    done[i] = capped[i] = True
                    self.release_slot(i)
            if all(done):
                break
            nxt = self.step(last_tok, gen, temperature)
            for i in range(len(prompts)):
                if done[i]:
                    continue
                tok = int(nxt[i])
                outs[i].append(tok)
                last_tok[i] = tok
                if self.eos_id is not None and tok == self.eos_id:
                    done[i] = True
                    self.release_slot(i)
            if all(done):
                break
        dt = _now() - t0
        results = []
        for i, p in enumerate(prompts):
            finished = bool(done[i]) if self.eos_id is not None else True
            results.append(GenerationResult(
                tokens=outs[i], prompt_len=len(p), steps=len(outs[i]),
                finished=finished and not capped[i], latency_s=dt,
                first_token_s=t_first))
            self.release_slot(i)
        return results
