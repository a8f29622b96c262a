"""Paged, tiered KV cache of the port: hot bf16 and warm int8 pages.

  block_pool   logical page identity: free-list allocator and per-request
               block tables with LRU stamps; knows nothing about tensors
  tiers        physical page representation: bf16 HOT pool or int8 WARM
               pool (per-token absmax scales, the CABA KV site), moved in
               place by batched movers
  policy       who moves and when: LRU victims and the controller trigger
               that gates compression
"""
from repro_torch.cache.block_pool import BlockPool, PoolExhausted
from repro_torch.cache.policy import (CachePolicy, TierConfig,
                                      decode_roofline_terms)
from repro_torch.cache.tiers import (TIER_HOT, TIER_WARM, PageGeometry,
                                     SegmentGeometry, TieredKVStore)

__all__ = ["BlockPool", "PoolExhausted", "TieredKVStore", "PageGeometry",
           "SegmentGeometry", "TIER_HOT", "TIER_WARM", "CachePolicy",
           "TierConfig", "decode_roofline_terms"]
