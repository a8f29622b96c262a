"""Admission/eviction policy for the tiered KV cache, hot and warm tiers.

Counterpart of ``repro.cache.policy`` without the cold tier and its
prefetch task:

1. WHETHER to compress at all -- the compress-task trigger: build the
   decode step's roofline terms and ask the AssistController about the KV
   site.  Memory-bound and compressible -> demotion enabled; otherwise the
   cache runs hot-only and admission waits for capacity.
2. WHO gets demoted -- LRU over pages (BlockPool.last_access stamps), with
   the active requests' pages protected so the decode never loses a page
   it reads this tick.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.assist import (AssistController, H100_SXM, HardwareSpec,
                                RooflineTerms, SiteDescriptor)
from repro_torch.cache.block_pool import BlockPool
from repro_torch.cache.tiers import TIER_HOT, TieredKVStore


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Device-memory budget split for the tiered store.  The cold tier is
    not ported: ``enable_cold=True`` raises."""
    page_size: int = 16
    hbm_budget_bytes: int = 1 << 24
    hot_fraction: float = 0.5       # share of the budget kept bf16
    enable_warm: bool = True
    enable_cold: bool = False

    def __post_init__(self):
        if self.enable_cold:
            raise NotImplementedError("cold tier not yet ported")

    def split_pages(self, hot_page_bytes: int, warm_page_bytes: int,
                    budget: Optional[int] = None):
        """(hot_pages, warm_pages) under the budget.  ``hot`` is floored at
        1; ``warm`` gets only what hot left over."""
        budget = self.hbm_budget_bytes if budget is None else budget
        hot_frac = self.hot_fraction if self.enable_warm else 1.0
        hot = max(1, int(budget * hot_frac) // hot_page_bytes)
        warm = 0
        if self.enable_warm:
            warm = max(0, (budget - hot * hot_page_bytes) // warm_page_bytes)
        return hot, warm


def kv_bytes_per_token(cfg) -> float:
    """bf16 KV bytes one token holds across the stack (dense GQA)."""
    return cfg.n_layers * 2.0 * cfg.n_kv_heads * cfg.head_dim * 2.0


def decode_roofline_terms(cfg, batch: int, resident_tokens: int,
                          kv_bytes: Optional[float] = None,
                          hw: HardwareSpec = H100_SXM) -> RooflineTerms:
    """Analytic roofline of one decode tick: every parameter and the
    resident KV stream once; compute is ~2 active-params FLOPs per token."""
    flops = 2.0 * cfg.active_param_count() * batch
    kv_per_tok = kv_bytes_per_token(cfg) if kv_bytes is None else kv_bytes
    mem = cfg.param_count() * 2.0 + resident_tokens * kv_per_tok
    return RooflineTerms(compute=flops / hw.peak_flops,
                         memory=mem / hw.hbm_bw, collective=0.0)


def kv_site(cfg, resident_tokens: int, measured_ratio: float = 1.0,
            kv_bytes: Optional[float] = None) -> SiteDescriptor:
    per_tok = kv_bytes_per_token(cfg) if kv_bytes is None else kv_bytes
    return SiteDescriptor("kv", max(resident_tokens * per_tok, 1.0),
                          "memory", lossless_required=False,
                          measured_ratio=measured_ratio)


def warm_ratio(head_dim: int) -> float:
    """int8+scale vs bf16 bytes per token-head: 2*dh -> dh + 4."""
    return (2.0 * head_dim) / (head_dim + 4.0)


class CachePolicy:
    """LRU + controller-trigger policy over (BlockPool, TieredKVStore)."""

    def __init__(self, cfg: TierConfig, *,
                 controller: Optional[AssistController] = None,
                 terms: Optional[RooflineTerms] = None,
                 site: Optional[SiteDescriptor] = None,
                 measured_ratio: float = 1.78, metrics=None):
        self.cfg = cfg
        self.controller = controller or AssistController(metrics=metrics)
        self.terms = terms
        self.decision = None
        enabled = cfg.enable_warm
        if terms is not None and site is not None:
            site = dataclasses.replace(site, measured_ratio=measured_ratio)
            self.decision = self.controller.decide(terms, site,
                                                   measured_ratio, "int8")
            enabled = enabled and self.decision.enabled
        self.compression_enabled = enabled

    def hot_victim(self, pool: BlockPool, store: TieredKVStore,
                   protected: set[int]) -> Optional[int]:
        """LRU hot page outside ``protected`` (pages the tick needs)."""
        order = pool.lru_order([p for p in store.hot_page_ids()
                                if p not in protected])
        return order[0] if order else None

    def make_hot_room(self, pool: BlockPool, store: TieredKVStore,
                      protected: set[int], n: int = 1) -> bool:
        """Demote LRU pages until >= n hot slots are free, as one batched
        mover episode.  Returns success."""
        with store.deferred():
            while store.n_free_hot < n:
                if not self.compression_enabled:
                    return False
                victim = self.hot_victim(pool, store, protected)
                if victim is None or not self.make_warm_room(pool, store,
                                                             protected):
                    return False
                store.demote_to_warm(victim)
        return True

    def make_warm_room(self, pool: BlockPool, store: TieredKVStore,
                       protected: set[int], n: int = 1) -> bool:
        """Whether >= n warm slots are free.  Without a cold tier nothing
        can leave the warm tier, so no room can be made: a full warm tier
        ends the eviction episode."""
        del pool, protected
        return store.n_free_warm >= n

    def park_pages(self, pool: BlockPool, store: TieredKVStore, page_ids,
                   protected: set[int]) -> int:
        """Push pages hot -> warm now, in one batched episode (a parked
        request's pages), skipping protected ones.  Returns pages moved."""
        moved = 0
        if not self.compression_enabled:
            return moved
        with store.deferred():
            for pid in page_ids:
                if pid in protected or store.tier[pid] != TIER_HOT:
                    continue
                if not self.make_warm_room(pool, store, protected):
                    continue
                store.demote_to_warm(pid)
                moved += 1
        return moved
