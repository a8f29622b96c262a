"""Paged, tiered KV cache of the port: hot bf16 and warm int8 pages on the
device, packed cold pages in host memory.

  block_pool   logical page identity: free-list allocator and per-request
               block tables with LRU stamps; knows nothing about tensors
  tiers        physical page representation: bf16 HOT pool, int8 WARM
               pool (per-token absmax scales, the CABA KV site), both moved
               in place by batched movers, or a COLD host record packed
               with BDI/FPC and decoded on the device at promotion
  policy       who moves and when: LRU victims, the controller trigger
               that gates compression, and the cold-page prefetch task
"""
from repro_torch.cache.block_pool import BlockPool, PoolExhausted
from repro_torch.cache.policy import (CachePolicy, TierConfig,
                                      decode_roofline_terms)
from repro_torch.cache.tiers import (TIER_COLD, TIER_HOT, TIER_WARM,
                                     ColdPageCorrupt, PageGeometry,
                                     SegmentGeometry, TieredKVStore)

__all__ = ["BlockPool", "PoolExhausted", "TieredKVStore", "PageGeometry",
           "SegmentGeometry", "TIER_HOT", "TIER_WARM", "TIER_COLD",
           "ColdPageCorrupt", "CachePolicy",
           "TierConfig", "decode_roofline_terms"]
