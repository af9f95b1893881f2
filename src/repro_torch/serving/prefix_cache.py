"""Content-addressed prefix cache over the paged KV pool (the port's copy
of ``repro/serving/prefix_cache.py``: numpy and hashlib only, with page
keys byte-identical to the JAX package's for the same tokens).

Design (vLLM-style prefix caching, host-side only — no device work):

- **Chained page keys.** Prompt token-ids are hashed at page granularity
  with a chained blake2b digest: ``key_i = H(key_{i-1} || tokens[iP:(i+1)P])``.
  A page's key therefore commits to its *entire* prefix, so two prompts
  share a page iff they share every token up to and including that page.
  Only full pages are keyed — a partial page's KV keeps changing as the
  slot decodes.

- **Content-addressed map + refcounts.** ``key -> pool page``; the engine
  tracks per-page reference counts (number of block tables pointing at the
  page). A cached page referenced by one or more slots is *shared* and
  read-only; the engine copy-on-writes before any KV write could land in
  one.

- **LRU free-candidates.** When the last reference to a cached page drops,
  the page is not freed: it parks in an LRU so a future prompt with the
  same prefix can still hit it. The allocator evicts from this list —
  oldest first — before declaring ``KV_POOL_EXHAUSTED``, so caching never
  reduces the pool capacity visible to admission. ``max_unreferenced``
  optionally caps how many unreferenced pages may park (the
  ``prefix_cache_pages`` deploy knob); overflow evicts immediately.

The cache is touched only from the engine's admission and retire paths,
which the scheduler's tick runs on one thread, so it takes no lock.
``GenerationEngine.check_pool_invariants`` audits it.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


def _page_digest(prev: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class PrefixCache:
    """Host-side registry: chained prefix hash -> pool page."""

    def __init__(self, page_size: int,
                 max_unreferenced: Optional[int] = None):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        if max_unreferenced is not None and max_unreferenced < 0:
            raise ValueError("max_unreferenced must be >= 0")
        self.page_size = page_size
        self.max_unreferenced = max_unreferenced
        self._by_key: Dict[bytes, int] = {}        # chain key -> pool page
        self._key_of: Dict[int, bytes] = {}        # pool page -> chain key
        # unreferenced cached pages, oldest first (the eviction order)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # counters (monotonic; surfaced via stats()/metrics gauges)
        self.hits = 0          # page-granularity lookup hits
        self.misses = 0        # full prompt pages that missed
        self.hit_tokens = 0    # tokens whose prefill the cache absorbed
        self.registered = 0    # pages ever registered
        self.evictions = 0     # pages evicted (LRU reclaim or cap overflow)
        self.cow_copies = 0    # copy-on-write page copies (engine-bumped)

    # -- hashing -----------------------------------------------------------

    def chain_keys(self, tokens: Sequence[int]) -> List[bytes]:
        """Chained keys for every FULL page of ``tokens`` (in order)."""
        P = self.page_size
        keys: List[bytes] = []
        digest = b""
        for start in range(0, (len(tokens) // P) * P, P):
            digest = _page_digest(digest, tokens[start:start + P])
            keys.append(digest)
        return keys

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: Sequence[int], *, peek: bool = False
              ) -> List[int]:
        """Pool pages holding the longest cached page-aligned prefix of
        ``tokens``. ``peek=True`` (admission probes) records no stats and
        leaves LRU order untouched; the real admission ``match`` marks the
        hit chain most-recently-used so hot prefixes survive eviction."""
        keys = self.chain_keys(tokens)
        pages: List[int] = []
        for key in keys:
            page = self._by_key.get(key)
            if page is None:
                break
            pages.append(page)
        if not peek:
            self.hits += len(pages)
            self.misses += len(keys) - len(pages)
            self.hit_tokens += len(pages) * self.page_size
            for page in pages:
                if page in self._lru:
                    self._lru.move_to_end(page)
        return pages

    # -- registration ------------------------------------------------------

    def register(self, key: bytes, page: int) -> bool:
        """Cache ``page`` (currently referenced by its computing slot)
        under ``key``. A key that already exists keeps its existing page —
        duplicate content computed concurrently stays private and frees
        normally — and a page cannot be registered twice."""
        if key in self._by_key or page in self._key_of:
            return False
        self._by_key[key] = page
        self._key_of[page] = key
        self.registered += 1
        return True

    def contains_page(self, page: int) -> bool:
        return page in self._key_of

    # -- reference transitions (driven by the engine's refcounts) ----------

    def ref_page(self, page: int):
        """``page`` gained its first block-table reference: it is no longer
        an eviction candidate."""
        self._lru.pop(page, None)

    def release_page(self, page: int) -> List[int]:
        """``page`` lost its last block-table reference: park it as an LRU
        eviction candidate. Returns pages evicted to enforce
        ``max_unreferenced`` — the caller returns those to the free pool."""
        self._lru[page] = None
        self._lru.move_to_end(page)
        out: List[int] = []
        while (self.max_unreferenced is not None
               and len(self._lru) > self.max_unreferenced):
            out.append(self._evict_oldest())
        return out

    # -- eviction ----------------------------------------------------------

    def _evict_oldest(self) -> int:
        page, _ = self._lru.popitem(last=False)
        key = self._key_of.pop(page)
        del self._by_key[key]
        self.evictions += 1
        return page

    def pop_evictable(self) -> Optional[int]:
        """Reclaim the least-recently-used unreferenced cached page (the
        allocator calls this before declaring the pool exhausted)."""
        if not self._lru:
            return None
        return self._evict_oldest()

    def evictable(self) -> int:
        """Unreferenced cached pages (reclaimable without touching any
        live request)."""
        return len(self._lru)

    def evictable_excluding(self, pages: Iterable[int]) -> int:
        """Evictable count if ``pages`` were taken off the candidate list —
        the admission gate must not count a prompt's own prospective hits
        as reclaimable headroom."""
        return len(self._lru) - sum(1 for p in set(pages) if p in self._lru)

    # -- introspection -----------------------------------------------------

    def cached_pages(self) -> List[int]:
        return sorted(self._key_of)

    def unreferenced_pages(self) -> List[int]:
        return list(self._lru)

    def stats(self) -> Dict[str, int]:
        return {
            "cached_pages": len(self._key_of),
            "unreferenced_pages": len(self._lru),
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "registered": self.registered,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
        }
