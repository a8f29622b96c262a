"""Logical KV page allocator with per-request block tables.

Counterpart of ``repro.cache.block_pool``.  A *page* holds ``page_size``
consecutive tokens of one request's KV across every layer; the pool hands
out page ids from a free list and keeps the request -> [page ids] tables
and LRU ``last_access`` stamps.  It owns no tensor data: which tier a
page's bytes live in is ``tiers.TieredKVStore``'s job.

Ownership keeps the reference's refcount fields (``owner``, ``refcount``,
``readers``) so copy-on-write prefix sharing can slot in later; this port
maps every page into exactly one table.

Invariants (``check``): every owned page's refcount equals its table
occurrences; no table repeats a page; the owner is a reader; free pages
have refcount 0 and no readers; len(free) + len(owned) == num_pages.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.obs.metrics import NULL_REGISTRY


class PoolExhausted(Exception):
    """No free page available (caller should evict or reject)."""


@dataclasses.dataclass
class PoolStats:
    allocated: int = 0
    freed: int = 0
    peak_in_use: int = 0


class BlockPool:
    """Free-list page allocator + per-request block tables."""

    def __init__(self, num_pages: int, page_size: int, *,
                 metrics=NULL_REGISTRY):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self.free: collections.deque[int] = collections.deque(range(num_pages))
        self.tables: dict[int, list[int]] = {}
        self.owner = np.full(num_pages, -1, np.int64)
        self.refcount = np.zeros(num_pages, np.int64)
        self.readers: dict[int, set[int]] = {}
        self.last_access = np.zeros(num_pages, np.int64)   # LRU tick stamps
        self.stats = PoolStats()
        self._c_alloc = metrics.counter(
            "pool_pages_allocated_total", "logical pages allocated")
        self._c_freed = metrics.counter(
            "pool_pages_freed_total", "logical pages freed")
        self._g_in_use = metrics.gauge(
            "pool_pages_in_use", "logical pages currently owned")
        self._g_peak = metrics.gauge(
            "pool_pages_peak_in_use", "high-water mark of owned pages")

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold n_tokens (ceil)."""
        return -(-n_tokens // self.page_size)

    @property
    def n_free(self) -> int:
        return len(self.free)

    def allocate(self, rid: int, n: int = 1) -> list[int]:
        """Append ``n`` fresh pages to ``rid``'s block table."""
        if n > len(self.free):
            raise PoolExhausted(f"need {n} pages, {len(self.free)} free")
        got = [self.free.popleft() for _ in range(n)]
        self.tables.setdefault(rid, []).extend(got)
        for p in got:
            self.owner[p] = rid
            self.refcount[p] = 1
            self.readers[p] = {rid}
        self.stats.allocated += n
        in_use = self.num_pages - len(self.free)
        self.stats.peak_in_use = max(self.stats.peak_in_use, in_use)
        self._c_alloc.inc(n)
        self._g_in_use.set(in_use)
        self._g_peak.set_max(in_use)
        return got

    def owners_of(self, pid: int):
        """Every rid currently mapping ``pid``."""
        return self.readers.get(pid, ())

    def free_request(self, rid: int) -> list[int]:
        """Release every page of ``rid``; returns the pages freed (the
        caller releases their tier storage)."""
        pages = self.tables.pop(rid, [])
        for p in pages:
            if rid not in self.readers.get(p, ()):
                raise ValueError(f"double free: rid {rid} lost page {p}")
            del self.readers[p]
            self.refcount[p] = 0
            self.owner[p] = -1
            self.free.append(p)
        self.stats.freed += len(pages)
        self._c_freed.inc(len(pages))
        self._g_in_use.set(self.num_pages - len(self.free))
        return pages

    def table(self, rid: int) -> list[int]:
        return self.tables.get(rid, [])

    def touch(self, rid: int, tick: int):
        """Stamp every page of ``rid`` as accessed at ``tick`` (LRU)."""
        for p in self.tables.get(rid, []):
            self.last_access[p] = tick

    def lru_order(self, candidates) -> list[int]:
        """Candidates sorted least-recently-used first (ties by page id;
        among equally old pages, shared ones go last)."""
        return sorted(candidates,
                      key=lambda p: (self.refcount[p] > 1,
                                     self.last_access[p], p))

    def check(self):
        """Raise AssertionError if a structural invariant is broken."""
        occurrences: dict[int, int] = collections.Counter()
        holders: dict[int, set[int]] = collections.defaultdict(set)
        for rid, pages in self.tables.items():
            if len(set(pages)) != len(pages):
                raise AssertionError(f"rid {rid} table has duplicate pages")
            for p in pages:
                if not 0 <= p < self.num_pages:
                    raise AssertionError(f"page {p} out of range")
                occurrences[p] += 1
                holders[p].add(rid)
        for p, n in occurrences.items():
            if self.refcount[p] != n:
                raise AssertionError(f"page {p} refcount {self.refcount[p]} "
                                     f"!= {n} table occurrences")
            if self.readers.get(p) != holders[p]:
                raise AssertionError(f"page {p} readers "
                                     f"{self.readers.get(p)} != {holders[p]}")
            if self.owner[p] not in holders[p]:
                raise AssertionError(f"page {p} owner {self.owner[p]} is "
                                     f"not a reader")
        free_set = set(self.free)
        if len(free_set) != len(self.free):
            raise AssertionError("free list has duplicates")
        if free_set & set(occurrences):
            raise AssertionError("page both free and owned")
        if len(free_set) + len(occurrences) != self.num_pages:
            raise AssertionError("page leaked")
        for p in free_set:
            if self.owner[p] != -1 or self.refcount[p] != 0 \
                    or p in self.readers:
                raise AssertionError(f"free page {p} still owned")
