"""Generation engine: bucketed prefill + fused batched decode with slot
management (counterpart of ``repro/serving/engine.py``).

The engine owns a fixed-capacity decode batch (``max_batch`` slots, each
with up to ``max_seq`` tokens of context). A request is prefilled alone
(its prompt padded to a power-of-two bucket) and *inserted* into a free
slot of the running batch cache — the mechanism continuous batching
(scheduler.py) is built on.

The decode fast path is sync-free. The next input token of each slot
lives on the device (``_next_tok``); ``insert_request`` returns the first
generated token as an unforced 0-d device tensor; ``step_chunk`` runs up
to ``decode_chunk`` decode steps with on-device sampling and per-slot
termination masks (EOS / token budget / ``max_seq`` capacity) and returns
device tensors, which the scheduler reads in one host sync per chunk.
Nothing inside a chunk calls ``.item()``, ``.tolist()``, ``.cpu()`` or
indexes with a boolean mask.

Host inputs (budgets, temperatures, the active mask, block-table rows)
cross to the device through pinned buffers with ``non_blocking=True``,
each staged in a fresh buffer, so the host never waits for the device
and never overwrites a buffer a copy may still read.

KV memory is *contiguous* (each slot owns a ``max_seq`` cache) or *paged*
(``paged=True``: a shared pool of ``kv_pool_blocks`` pages of
``page_size`` tokens, reached through per-slot block tables; decode runs
the paged decode kernel on the pool in place). The engine owns the page
allocator on the host (free list and table mirror; device rows are pushed
without a sync): prefill allocates the prompt's pages plus the page of
the first decode write, ``ensure_capacity`` secures a page per upcoming
write, and retire returns every page. Only a linear cache pages; a ring
cache (a sliding window shorter than ``max_seq``, the hybrid's local
attention, the SSM's state) keeps the linear layout silently, as in the
JAX package.

``prefix_cache=True`` (paged engines only) adds the content-addressed
prefix cache (``serving/prefix_cache.py``). Admission splits a prompt at
page boundaries: the cached prefix is installed by reference (refcount,
no compute), a cold prompt's aligned part is prefilled and registered,
and the rest is fed through masked decode steps (``_fill``), which also
give the first token — so a warm replay runs the same numeric path as
its cold run past the prefix boundary and gives the same tokens. Shared
and registered pages are read-only: the one write that could land in one
(the replay of the last token of a wholly cached prompt) copies the page
first, and unreferenced cached pages park in an LRU the allocator evicts
from before it reports the pool exhausted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.models.transformer import CACHE_BATCH_AXIS
from repro_torch.serving.prefix_cache import PrefixCache
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
                 page_size: int = 16, kv_pool_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefix_cache_pages: Optional[int] = None,
                 device: DeviceLike = "cuda"):
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
        # decode steps (each runs every layer once, active or masked;
        # prefix fills included) and prefills dispatched — the counts a
        # kernel-launch audit compares against
        self.steps_dispatched = 0
        self.prefills_dispatched = 0
        # host-side summary of the most recent admission (prompt tokens,
        # prefix-cache hit tokens, pages allocated, COW): read by the
        # scheduler's tracer right after insert_request, never a device
        # value
        self.last_admission: Optional[Dict[str, Any]] = None
        # Ring families (the hybrid's local attention, the SSM's state, a
        # sliding window shorter than max_seq) keep their cache layout and
        # left-pad prompts (pads count as context, and run through the
        # recurrences); a window >= max_seq never wraps, so the cache is
        # plain linear and pageable. A paged request on a ring family
        # falls back to it silently (``engine.py:123-134`` of the JAX
        # package).
        self._ring = (self.cfg.family in ("hybrid", "ssm")
                      or (self.cfg.sliding_window is not None
                          and self.cfg.sliding_window < max_seq))
        self.paged = bool(paged) and not self._ring
        self.page_size = 0
        self.kv_pool_blocks = 0
        if self.paged:
            if max_seq % page_size:
                raise ValueError(
                    f"page_size {page_size} must divide max_seq {max_seq}")
            self.page_size = page_size
            self._pages_per_slot = max_seq // page_size
            # default pool: the contiguous layout's capacity
            self.kv_pool_blocks = int(kv_pool_blocks) if kv_pool_blocks \
                else max_batch * self._pages_per_slot
        # prefix caching rides the paged layout (block tables are what make
        # cross-slot page sharing possible)
        self._prefix = self.paged and bool(prefix_cache)
        self._prefix_cap = prefix_cache_pages
        self.reset()
        self._kv_bytes_per_token = self._bytes_per_token(self._cache)

    @staticmethod
    def _bytes_per_token(cache) -> int:
        """Device bytes one token of context costs across all layers (0
        for the SSM's constant-size state)."""
        for key in ("k_pool", "k", "attn_k"):    # [L|nb, ., ., KV, hd]
            if key in cache:
                k = cache[key]
                return 2 * k.shape[0] * k.shape[3] * k.shape[4] \
                    * k.element_size()
        return 0

    def bind_thread(self):
        """Make the engine's card the calling thread's current device: a
        thread that takes over the engine (a respawned worker) starts on
        the process's default one."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

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

    # -- paged pool management (host side; device work stays sync-free) -----

    def _insert_paged(self, one_cache, slot: int):
        """Copy a B=1 linear prefill cache (``max_seq`` long) into the
        pool pages the slot has allocated, and push its table row. Only
        allocated pages are written, so no index needs dropping."""
        blocks = self._slot_blocks[slot]
        nb, P = self._pages_per_slot, self.page_size
        idx = self._h2d(blocks, torch.int64)
        for name, src in (("k_pool", one_cache["k"]),
                          ("v_pool", one_cache["v"])):
            pages = src[:, 0].reshape(src.shape[0], nb, P, *src.shape[3:])
            self._cache[name][:, idx] = pages[:, :len(blocks)].to(
                self._cache[name].dtype)
        self._cache["lengths"][slot] = one_cache["lengths"][0]
        self._push_table_row(slot)

    def _insert(self, one_cache, slot: int):
        """Copy every leaf of a B=1 prefill cache into ``slot`` of the
        batch cache, in place (the JAX engine donates it), along each
        leaf's named batch axis."""
        for name, dst in self._cache.items():
            ax = CACHE_BATCH_AXIS[name]
            dst.select(ax, slot).copy_(one_cache[name].select(ax, 0))

    def _alloc_blocks(self, slot: int, n: int) -> bool:
        """Move ``n`` pool pages to ``slot`` (all-or-nothing). With a
        prefix cache, unreferenced cached pages are LRU-evicted into the
        free list first — retained cache never shrinks the pool capacity
        admission can claim."""
        if self.prefix_cache is not None:
            while len(self._free_pool) < n:
                page = self.prefix_cache.pop_evictable()
                if page is None:
                    break
                self._free_pool.append(page)
        if len(self._free_pool) < n:
            return False
        start = len(self._slot_blocks[slot])
        for i in range(n):
            blk = self._free_pool.pop()
            self._slot_blocks[slot].append(blk)
            self._table[slot, start + i] = blk
            if self.prefix_cache is not None:
                self._page_refs[blk] = 1
        return True

    def _take_free_page(self) -> Optional[int]:
        """One pool page for a copy-on-write target (evicting from the
        prefix cache if the free list is dry); None when truly exhausted."""
        if not self._free_pool and self.prefix_cache is not None:
            page = self.prefix_cache.pop_evictable()
            if page is not None:
                self._free_pool.append(page)
        if not self._free_pool:
            return None
        blk = self._free_pool.pop()
        self._page_refs[blk] = 1
        return blk

    def _decref(self, blk: int):
        """Drop one block-table reference to ``blk``. The last reference
        frees the page — unless it is cache-registered, where it parks as
        an LRU eviction candidate instead (cap overflow evicts to free)."""
        self._page_refs[blk] -= 1
        assert self._page_refs[blk] >= 0, f"page {blk} refcount underflow"
        if self._page_refs[blk] == 0:
            if self.prefix_cache.contains_page(blk):
                self._free_pool.extend(self.prefix_cache.release_page(blk))
            else:
                self._free_pool.append(blk)

    def _page_writable(self, blk: int) -> bool:
        """A page may take KV writes only while it is uniquely owned and
        not content-addressed."""
        return (self._page_refs[blk] == 1
                and not self.prefix_cache.contains_page(blk))

    def _make_writable(self, slot: int, pos: int) -> bool:
        """Copy-on-write guard for the page holding position ``pos`` of
        ``slot``: a shared or cache-registered page is copied into a fresh
        page, the slot's table entry repointed and the shared reference
        dropped. False when no page can be had for the copy (the caller
        retires the slot)."""
        pi = pos // self.page_size
        if pi >= len(self._slot_blocks[slot]):
            return True                     # next write page not allocated
        blk = self._slot_blocks[slot][pi]
        if self._page_writable(blk):
            return True
        fresh = self._take_free_page()
        if fresh is None:
            return False
        self._copy_page(blk, fresh)
        self._slot_blocks[slot][pi] = fresh
        self._table[slot, pi] = fresh
        self._push_table_row(slot)
        self._decref(blk)
        self.prefix_cache.cow_copies += 1
        return True

    def _copy_page(self, src: int, dst: int):
        """Device-side pool page copy (all layers, k and v), queued like
        every other cache op — never a host sync."""
        for name in ("k_pool", "v_pool"):
            pool = self._cache[name]
            pool[:, dst].copy_(pool[:, src])

    def _push_table_row(self, slot: int):
        """Mirror the slot's host table row to the device table: a fresh
        pinned staging buffer per push and a non-blocking copy, so a chunk
        in flight never sees the host mutate its source."""
        self._cache["block_table"][slot] = self._h2d(self._table[slot],
                                                     torch.int32)

    def free_blocks(self) -> int:
        """Unallocated pool pages (0 for contiguous engines)."""
        return len(self._free_pool)

    def available_blocks(self) -> int:
        """Pool pages admission may claim: the free list plus every
        unreferenced cached page the allocator could evict."""
        avail = len(self._free_pool)
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable()
        return avail

    def blocks_in_use(self) -> int:
        """Pages referenced by live slots — shared pages count once, and
        cache-retained (unreferenced) pages are not live context."""
        used = self.kv_pool_blocks - len(self._free_pool)
        if self.prefix_cache is not None:
            used -= self.prefix_cache.evictable()
        return used

    def _prompt_page_plan(self, prompt: List[int]
                          ) -> Tuple[int, List[int], int]:
        """(total pages the seated prompt references, cached pages backing
        its longest hashed prefix, extra pages copy-on-write will draw).
        The COW page appears exactly when the whole prompt is cached."""
        n = len(prompt)
        total = -(-(n + 1) // self.page_size)
        hits = self.prefix_cache.match(prompt, peek=True)
        cow = 1 if len(hits) * self.page_size >= n else 0
        return total, hits, cow

    def blocks_for_prompt(self, prompt) -> int:
        """Pool pages admission must see claimable before taking this
        prompt: its prefill pages plus room for the first decode write. A
        token list lets a prefix-cached engine charge only the pages the
        cache cannot seat; a bare length is the full charge."""
        if isinstance(prompt, (int, np.integer)):
            n, toks = int(prompt), None
        else:
            toks = list(prompt)
            n = len(toks)
        total = -(-(n + 1) // self.page_size)
        if toks is None or self.prefix_cache is None:
            return total
        _, hits, cow = self._prompt_page_plan(toks)
        return total - len(hits) + cow

    def can_admit(self, prompt) -> bool:
        """Block-aware admission gate: beyond :meth:`fits_prompt`, a paged
        engine needs enough claimable pool pages for the prompt (never
        counting the prompt's own prospective hits as evictable)."""
        if isinstance(prompt, (int, np.integer)):
            n, toks = int(prompt), None
        else:
            toks = list(prompt)
            n = len(toks)
        if not self.fits_prompt(n):
            return False
        if not self.paged:
            return True
        if toks is None or self.prefix_cache is None:
            return self.available_blocks() >= self.blocks_for_prompt(n)
        total, hits, cow = self._prompt_page_plan(toks)
        avail = (len(self._free_pool)
                 + self.prefix_cache.evictable_excluding(hits))
        return avail >= total - len(hits) + cow

    def ensure_capacity(self, slot: int, want: int) -> int:
        """Secure write headroom for up to ``want`` more KV entries on
        ``slot``, allocating pool pages as needed and available. Returns
        the writes available — fewer than ``want`` when the pool is tight,
        0 when the slot cannot take a single further write (the caller
        retires it). Contiguous engines report the ``max_seq`` headroom."""
        length = int(self._lengths[slot])
        phys = self.max_seq - length
        if not self.paged:
            return max(0, min(want, phys))
        want = min(want, phys)
        have = len(self._slot_blocks[slot]) * self.page_size - length
        dirty = False
        while have < want and self.available_blocks() \
                and len(self._slot_blocks[slot]) < self._pages_per_slot:
            self._alloc_blocks(slot, 1)
            have += self.page_size
            dirty = True
        if dirty:
            self._push_table_row(slot)
        if self.prefix_cache is not None and want > 0 and have > 0:
            # read-only page invariant: the next write lands at ``length``;
            # copy-on-write its page if it is shared or registered
            if not self._make_writable(slot, length):
                return 0
        return max(0, min(want, have))

    def kv_stats(self) -> Dict[str, Any]:
        """KV memory accounting: a contiguous cache charges the full
        ``max_seq`` per occupied slot, a paged cache the pool pages in
        use."""
        bpt = self._kv_bytes_per_token
        active = int(self._active.sum())
        logical = self.active_logical_tokens()
        if self.paged:
            used = self.blocks_in_use()
            in_use = used * self.page_size * bpt
            out: Dict[str, Any] = {
                "paged": True, "page_size": self.page_size,
                "pool_blocks": self.kv_pool_blocks,
                "blocks_in_use": used,
                "free_blocks": len(self._free_pool),
            }
            if self.prefix_cache is not None:
                # cache-retained pages are claimable, not live context
                out["cached_blocks"] = self.prefix_cache.evictable()
                out["prefix_cache"] = self.prefix_stats()
        else:
            in_use = active * self.max_seq * bpt
            out = {"paged": False}
        out.update(active_slots=active, active_tokens=logical,
                   kv_bytes_per_token=bpt, kv_bytes_in_use=int(in_use),
                   kv_bytes_per_active_token=(round(in_use / logical, 1)
                                              if logical else 0.0))
        return out

    def prefix_stats(self) -> Optional[Dict[str, int]]:
        """Prefix-cache counters plus the pages referenced by more than one
        block table; None without a prefix cache."""
        if self.prefix_cache is None:
            return None
        s = self.prefix_cache.stats()
        s["shared_pages"] = int((self._page_refs > 1).sum())
        return s

    def check_pool_invariants(self, *, device: bool = True):
        """Audit the page allocator (test hook; ``device=True`` also reads
        the device block table back — a host sync).

        Every pool page is exactly one of: free (on the free list,
        unreferenced); live (refcount == the number of table references);
        cache-retained (registered, unreferenced, in the LRU). A freed page
        is never still referenced from any table."""
        assert self.paged, "invariant audit is for paged engines"
        refs: Dict[int, int] = {}
        for s in range(self.max_batch):
            blocks = self._slot_blocks[s]
            for i, pg in enumerate(blocks):
                assert 0 <= pg < self.kv_pool_blocks, (s, i, pg)
                assert self._table[s, i] == pg, \
                    f"host table desync at slot {s} page {i}"
                refs[pg] = refs.get(pg, 0) + 1
            assert (self._table[s, len(blocks):]
                    == self.kv_pool_blocks).all(), \
                f"slot {s} table not sentinel past its allocation"
        free = set(self._free_pool)
        assert len(free) == len(self._free_pool), "double-freed page"
        assert not free & set(refs), \
            f"freed pages still referenced: {sorted(free & set(refs))}"
        if self.prefix_cache is not None:
            for pg in range(self.kv_pool_blocks):
                assert int(self._page_refs[pg]) == refs.get(pg, 0), \
                    (f"page {pg} refcount {int(self._page_refs[pg])} != "
                     f"{refs.get(pg, 0)} table references")
            lru = set(self.prefix_cache.unreferenced_pages())
            cached = set(self.prefix_cache.cached_pages())
            assert lru <= cached
            assert not lru & free and not lru & set(refs)
            assert cached - set(refs) == lru, \
                "unreferenced cached page missing from the LRU"
            covered = free | set(refs) | lru
        else:
            covered = free | set(refs)
        assert covered == set(range(self.kv_pool_blocks)), \
            f"leaked pages: {sorted(set(range(self.kv_pool_blocks)) - covered)}"
        if device:
            dev = self._cache["block_table"].cpu().numpy()
            assert (dev == self._table).all(), "device table desync"

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
        """KV writes remaining before ``slot`` cannot decode another token;
        on a paged engine also bounded by the slot's pages plus what the
        pool could still provide."""
        left = int(self.max_seq - self._lengths[slot])
        if self.paged:
            have = (len(self._slot_blocks[slot]) * self.page_size
                    - int(self._lengths[slot]))
            left = min(left, have + self.available_blocks() * self.page_size)
        return max(0, left)

    def _first_token(self, logits_row, slot: int) -> torch.Tensor:
        """Greedy first token from one row of logits, written into the
        device next-token buffer; returned as an unforced 0-d tensor."""
        first = torch.argmax(mask_padded_vocab(logits_row,
                                               self.cfg.vocab_size))
        first = first.to(torch.int32)
        self._next_tok[slot] = first
        return first

    def _prefill(self, tokens: List[int], bucket: int, true_len: int,
                 left_pad: bool = False):
        """Prefill one prompt padded to ``bucket``: (logits [1, V], a B=1
        linear cache of ``max_seq``)."""
        padded = np.zeros((1, bucket), np.int32)
        if left_pad:
            padded[0, bucket - len(tokens):] = tokens
        else:
            padded[0, :len(tokens)] = tokens
        batch = {"tokens": self._h2d(padded, torch.int32),
                 "prompt_lengths": self._h2d([true_len], torch.int32)}
        self.prefills_dispatched += 1
        return self.model.prefill(self.params, batch, cache_len=self.max_seq)

    def insert_request(self, prompt: List[int], slot: int) -> torch.Tensor:
        """Prefill ``prompt`` into ``slot``; returns the first generated
        token as an *unforced* 0-d device tensor (greedy argmax over the
        prefill logits). Callers read it at their next sync point."""
        assert not self._active[slot], f"slot {slot} busy"
        bucket = _bucket(len(prompt))
        if bucket > self.max_seq:
            raise ValueError(
                f"prompt {len(prompt)} exceeds max_seq {self.max_seq}")
        if self.prefix_cache is not None:
            return self._insert_cached(list(prompt), slot)
        # ring caches need contiguous positions, so their prompts are
        # LEFT-padded and pads are context; linear caches RIGHT-pad, causal
        # masking keeps pads out of real tokens' attention and decode
        # masks by the true length
        true_len = bucket if self._ring else len(prompt)
        if self.paged:
            # the prefill's pages plus the page of the first decode write,
            # secured before any compute (blocks_for_prompt is the one
            # statement of this rule, shared with the admission gate)
            need = self.blocks_for_prompt(len(prompt))
            if not self._alloc_blocks(slot, need):
                raise RuntimeError(
                    f"KV pool exhausted: prompt needs {need} pages, "
                    f"{len(self._free_pool)} of {self.kv_pool_blocks} free")
        # host mirrors flip before the dispatch (stats readers on other
        # threads never see a busy slot or allocated pages without an owner)
        self._lengths[slot] = true_len
        self._prompt_lens[slot] = len(prompt)
        self._prefill_lens[slot] = true_len
        self._active[slot] = True
        try:
            logits, one = self._prefill(prompt, bucket, true_len,
                                        left_pad=self._ring)
            if self.paged:
                self._insert_paged(one, slot)
            else:
                self._insert(one, slot)
            first = self._first_token(logits[0], slot)
        except Exception:
            self.release_slot(slot)     # no orphaned slot or leaked pages
            raise
        self.last_admission = {
            "prompt_tokens": len(prompt), "cached_hit_tokens": 0,
            "pages_allocated": need if self.paged else 0, "cow": False}
        return first

    def _insert_cached(self, prompt: List[int], slot: int) -> torch.Tensor:
        """Prefix-cached admission (``engine.py:888-`` of the JAX package).
        The prompt splits at page boundaries:

        - ``[0, hit_len)``, the longest cached prefix: its pool pages go
          into the slot's table by reference, with no compute;
        - the rest: on a cold miss the aligned part is prefilled, then the
          tail (on a partial hit, the whole miss region) is fed through
          masked decode steps (:meth:`_fill`), which also give the first
          token.

        When the whole prompt is cached (page-aligned), its last token is
        replayed for its logits; that write targets the final shared page,
        which is copied first, so cached bytes never change. Freshly
        computed full prompt pages register at once, so duplicates
        admitted later in the same tick already hit."""
        n = len(prompt)
        P = self.page_size
        cache = self.prefix_cache
        total = -(-(n + 1) // P)          # prompt pages + first decode write
        hits = cache.match(prompt)
        hit_len = len(hits) * P
        assert not self._slot_blocks[slot], f"slot {slot} holds pages"
        for i, pg in enumerate(hits):
            self._slot_blocks[slot].append(pg)
            self._table[slot, i] = pg
            self._page_refs[pg] += 1
            cache.ref_page(pg)
        if not self._alloc_blocks(slot, total - len(hits)):
            self.release_slot(slot)       # drop the shared refs taken above
            raise RuntimeError(
                f"KV pool exhausted: prompt needs {total - len(hits)} new "
                f"pages, {self.available_blocks()} of "
                f"{self.kv_pool_blocks} claimable")
        self._push_table_row(slot)
        # host mirrors flip before the dispatches (paged prompts are
        # linear: logical == physical == n)
        self._lengths[slot] = n
        self._prompt_lens[slot] = n
        self._prefill_lens[slot] = n
        self._active[slot] = True
        self._slot_cacheable[slot] = True
        try:
            if hit_len >= n:              # full hit: replay the last token
                start = n - 1
                if not self._make_writable(slot, start):
                    raise RuntimeError(
                        "KV pool exhausted: no page for the replay "
                        "copy-on-write")
            elif not hits and n - 1 >= P:
                # cold miss: the aligned prefix through the regular prefill
                start = ((n - 1) // P) * P
                _, one = self._prefill(prompt[:start], _bucket(start), start)
                self._insert_paged(one, slot)
            else:                         # partial hit (or a tiny prompt)
                start = hit_len
            first = self._fill(prompt[start:], start, slot)
            keys = cache.chain_keys(prompt)
            for i in range(len(hits), n // P):
                cache.register(keys[i], self._slot_blocks[slot][i])
        except Exception:
            self.release_slot(slot)     # no orphaned slot or leaked pages
            raise
        # warm vs cold: hit tokens were installed by reference, only the
        # remainder paid pages and compute
        self.last_admission = {
            "prompt_tokens": n, "cached_hit_tokens": min(hit_len, n),
            "pages_allocated": total - len(hits), "cow": hit_len >= n}
        return first

    def _fill(self, tail: List[int], start: int, slot: int) -> torch.Tensor:
        """Feed ``tail`` into ``slot`` from position ``start``, one masked
        decode step per token: each step writes one KV entry exactly as
        decode does (so a tail's pages equal decode-made ones), and the
        last step's logits give the first generated token. Other slots run
        masked — their lengths hold and their writes land past their valid
        length, as in a chunk. The JAX package pads the count to a power
        of two for its compiled scan; here exactly ``len(tail)`` steps
        run."""
        # fill_ passes the value to a kernel; an item assignment from a
        # Python int would copy it from pageable memory, a host sync
        self._cache["lengths"][slot].fill_(start)
        tokens = np.zeros((len(tail), self.max_batch), np.int32)
        tokens[:, slot] = tail
        mine = np.zeros((self.max_batch,), bool)
        mine[slot] = True
        tokens_d = self._h2d(tokens, torch.int32)
        active = self._h2d(mine, torch.bool)
        for i in range(len(tail)):
            logits, self._cache = self.model.decode_step(
                self.params, self._cache, tokens_d[i], active=active)
            self.steps_dispatched += 1
        return self._first_token(logits[slot], slot)

    def release_slot(self, slot: int, tokens: Optional[List[int]] = None):
        """Retire ``slot`` and return its KV pages.

        ``tokens`` (prompt + generated, as fed) lets a prefix-cached
        engine register the slot's fully written pages before the
        references drop, so a multi-turn continuation hits the whole
        previous exchange. On the last reference a registered page parks
        in the LRU; every other page frees. The slot's table row returns
        to the sentinel on the device too: a free slot still runs masked
        decode writes, which must not land in pages another slot owns."""
        self._active[slot] = False
        if not (self.paged and self._slot_blocks[slot]):
            return
        if self.prefix_cache is None:
            self._free_pool.extend(self._slot_blocks[slot])
        else:
            if tokens is not None and self._slot_cacheable[slot]:
                # pages wholly covered by KV actually written, keyed by the
                # tokens that fed them
                full = min(int(self._lengths[slot]), len(tokens)) \
                    // self.page_size
                keys = self.prefix_cache.chain_keys(
                    tokens[:full * self.page_size])
                for i, key in enumerate(keys):
                    self.prefix_cache.register(key,
                                               self._slot_blocks[slot][i])
            for pg in self._slot_blocks[slot]:
                self._decref(pg)
            self._slot_cacheable[slot] = False
        self._slot_blocks[slot] = []
        self._table[slot, :] = self.kv_pool_blocks
        self._push_table_row(slot)

    def reset(self):
        """Rebuild every piece of mutable serving state: the KV cache (and
        on paged engines the pool, tables, refcounts and prefix cache), the
        host length/active mirrors and the device next-token buffer.
        Weights survive; active slots are abandoned. The old cache is
        dropped before the new one is allocated, so a rebuild's device
        peak stays at one cache (when nothing else holds the old one)."""
        max_batch, max_seq = self.max_batch, self.max_seq
        self._cache = self._next_tok = None
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        self._free_pool: List[int] = list(range(self.kv_pool_blocks))
        self.prefix_cache: Optional[PrefixCache] = None
        if self.paged:
            # host mirror of the device block table (sentinel = pool size)
            self._table = np.full((max_batch, self._pages_per_slot),
                                  self.kv_pool_blocks, np.int32)
            self._cache = self.model.init_cache(
                max_batch, max_seq, device=self.device,
                paged=(self.kv_pool_blocks, self.page_size))
        else:
            self._cache = self.model.init_cache(max_batch, max_seq,
                                                device=self.device)
        if self._prefix:
            self.prefix_cache = PrefixCache(
                self.page_size, max_unreferenced=self._prefix_cap)
            # block-table references per pool page (1 = uniquely owned,
            # >1 = shared; shared or registered pages are read-only)
            self._page_refs = np.zeros((self.kv_pool_blocks,), np.int32)
            self._slot_cacheable = [False] * max_batch
        self._lengths = np.zeros((max_batch,), np.int32)
        self._active = np.zeros((max_batch,), bool)
        self._prompt_lens = np.zeros((max_batch,), np.int32)
        self._prefill_lens = np.zeros((max_batch,), np.int32)
        self._next_tok = torch.zeros((max_batch,), dtype=torch.int32,
                                     device=self.device)
        self.last_admission = None

    def step(self, tokens, generator: Optional[torch.Generator],
             temperature=0.0) -> np.ndarray:
        """One decode step for the whole batch (reads the result on the
        host). tokens [max_batch] int; ``temperature`` is a scalar or a
        per-slot vector. Slots whose cache is full are masked: they emit 0
        and do not advance."""
        writable = self._active & (self._lengths < self.max_seq)
        if self.paged:
            for i in np.flatnonzero(writable):
                if self.ensure_capacity(int(i), 1) < 1:
                    writable[i] = False
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

        On a paged engine the caller first secures a page for every
        budgeted write with :meth:`ensure_capacity` and caps ``budgets`` at
        what it grants (the device cannot allocate); the scheduler does
        this for every chunk.

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
