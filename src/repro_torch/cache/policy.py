"""Admission/eviction/prefetch policy for the tiered KV cache.

Counterpart of ``repro.cache.policy`` for token pages:

1. WHETHER to compress at all -- the compress-task trigger: build the
   decode step's roofline terms and ask the AssistController about the KV
   site.  Memory-bound and compressible -> demotion enabled; otherwise the
   cache runs hot-only and admission waits for capacity.
2. WHO gets demoted -- LRU over pages (BlockPool.last_access stamps), with
   the active requests' pages protected so the decode never loses a page
   it reads this tick; a full warm tier spills its LRU page cold.
3. WHEN cold pages come back -- the ``coldpage`` prefetch task (WaSP
   lookahead): when a decode lane is within ``prefetch_lookahead`` steps
   of finishing, the next parked request's cold pages start promoting
   ahead of the swap-in, up to the controller's per-tick page budget.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.assist import (REGISTRY, AssistController, H100_SXM,
                                HardwareSpec, RooflineTerms, SiteDescriptor)
from repro_torch.cache.block_pool import BlockPool, PoolExhausted
from repro_torch.cache.tiers import (TIER_COLD, TIER_HOT, TIER_WARM,
                                     TieredKVStore)


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Device/host budget split for the tiered store."""
    page_size: int = 16
    hbm_budget_bytes: int = 1 << 24
    hot_fraction: float = 0.5       # share of the budget kept bf16
    enable_warm: bool = True
    enable_cold: bool = True
    host_budget_bytes: Optional[int] = None   # None = unbounded host spill
    prefetch_lookahead: int = 2
    pages_per_prefetch_tick: int = 2
    cold_delta: bool = True         # delta-along-sequence before packing
    async_prefetch: bool = True     # promote on a side stream

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
    """LRU + assist-task policy over (BlockPool, TieredKVStore)."""

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
        self.cold_enabled = cfg.enable_cold and enabled
        # cold-page promotion is the prefetch assist task
        self.prefetch = REGISTRY.get("coldpage", kind="prefetch").build(
            pages_per_tick=cfg.pages_per_prefetch_tick,
            async_promote=cfg.async_prefetch, metrics=metrics,
            controller=self.controller)

    @property
    def stats(self) -> dict:
        """The prefetch counters under the reference's key names."""
        return self.prefetch.counters

    def hot_victim(self, pool: BlockPool, store: TieredKVStore,
                   protected: set[int]) -> Optional[int]:
        """LRU hot page outside ``protected`` (pages the tick needs)."""
        order = pool.lru_order([p for p in store.hot_page_ids()
                                if p not in protected])
        return order[0] if order else None

    def warm_victim(self, pool: BlockPool, store: TieredKVStore,
                    protected: set[int]) -> Optional[int]:
        order = pool.lru_order([p for p in store.warm_page_ids()
                                if p not in protected])
        return order[0] if order else None

    def make_hot_room(self, pool: BlockPool, store: TieredKVStore,
                      protected: set[int], n: int = 1) -> bool:
        """Demote LRU pages until >= n hot slots are free, as one batched
        mover episode (a full warm tier spills cold first).  Returns
        success."""
        guard = 0
        with store.deferred():
            while store.n_free_hot < n and guard < 4 * pool.num_pages:
                guard += 1
                if not self.compression_enabled:
                    return False
                victim = self.hot_victim(pool, store, protected)
                if victim is None:
                    return False
                if store.n_free_warm == 0 and not self.make_warm_room(
                        pool, store, protected):
                    return False
                store.demote_to_warm(victim)
        return store.n_free_hot >= n

    def make_warm_room(self, pool: BlockPool, store: TieredKVStore,
                       protected: set[int], n: int = 1) -> bool:
        """Demote LRU warm pages cold until >= n warm slots are free.  A
        full host budget ends the episode."""
        guard = 0
        while store.n_free_warm < n and guard < 4 * pool.num_pages:
            guard += 1
            if not self.cold_enabled:
                return False
            victim = self.warm_victim(pool, store, protected)
            if victim is None:
                return False
            try:
                store.demote_to_cold(victim)
            except PoolExhausted:      # host budget full
                return False
            # a page demoted back to cold is no longer a usable prefetch
            self.prefetch.discard_prefetched(victim)
        return store.n_free_warm >= n

    def park_pages(self, pool: BlockPool, store: TieredKVStore, page_ids,
                   protected: set[int]) -> int:
        """Push pages down the ladder (hot -> warm -> cold) in one batched
        episode, skipping protected ones; a full host budget stops the
        cold phase without failing the park.  Returns the tier moves."""
        moved = 0
        with store.deferred():
            if self.compression_enabled:
                for pid in page_ids:
                    if pid in protected or store.tier[pid] != TIER_HOT:
                        continue
                    if store.n_free_warm == 0 and not self.make_warm_room(
                            pool, store, protected):
                        continue
                    store.demote_to_warm(pid)
                    moved += 1
            if self.cold_enabled:
                for pid in page_ids:
                    if pid in protected or store.tier[pid] != TIER_WARM:
                        continue
                    try:
                        store.demote_to_cold(pid)
                    except PoolExhausted:   # host budget full: park warm
                        break
                    self.prefetch.discard_prefetched(pid)
                    moved += 1
        return moved

    # -- prefetch task delegation (WaSP lookahead, paper 8.2) ----------------

    def schedule_prefetch(self, page_ids, kind: str = "lookahead"):
        """Queue cold pages of a soon-to-run request for promotion."""
        self.prefetch.schedule(page_ids, kind=kind)

    def drain_prefetch(self, pool: BlockPool, store: TieredKVStore,
                       protected: set[int]):
        """Promote queued cold pages up to the controller's page budget."""
        budget = None
        if self.terms is not None:
            site = SiteDescriptor("kv_cold", store.geom.warm_page_bytes,
                                  "memory", lossless_required=False)
            d = self.prefetch.plan(site, self.terms)
            if not d.enabled:
                return
            budget = min(d.budget, self.cfg.pages_per_prefetch_tick)
        self.prefetch.apply(
            store, protected,
            lambda prot: self.make_warm_room(pool, store, prot),
            is_cold=lambda pid: store.tier[pid] == TIER_COLD,
            budget=budget)

    def account_swap_in(self, page_ids, cold_page_ids):
        self.prefetch.account_swap_in(page_ids, cold_page_ids)

    def forget_pages(self, page_ids):
        self.prefetch.forget_pages(page_ids)
