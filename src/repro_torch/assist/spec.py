"""AssistSpec: the declarative assist configuration of a deployment.

Counterpart of ``repro.assist.spec`` with the fields this port serves:
the dense engine's cache mode, the paged KV cache, its attention backend,
its hot/warm/cold tiers and the cold-page prefetch task, with the
reference's defaults.  The spec is configuration only: it imports no cache
or serving layer.

  kv                   DENSE-engine cache mode: "bf16" | "int8".  The
                       paged engine ignores it: there the int8 site is
                       the warm tier (enable_warm), hot pages stay bf16
  paged                page the KV cache instead of slots
  attn_backend         paged decode attention (kernels/decode_attn/ops.py)
  page_size            tokens per page
  hbm_budget_mb        device-memory budget for the page pools (MiB)
  hbm_budget_bytes     exact-byte override of hbm_budget_mb
  hot_fraction         share of the budget kept bf16
  enable_warm          int8 warm tier (the CABA KV site)
  enable_cold          packed host cold tier (delta + BDI/FPC, RAW fallback)
  host_budget_bytes    cold-tier budget (None = unbounded)
  max_cold_pages       hard cap on cold page ids (None = derive from the
                       host budget / device pools)
  cold_delta           delta-along-sequence transform before cold packing
  use_roofline_trigger let the controller's trigger gate demotion

Prefetch task (paper 8.2):
  prefetch_lookahead       ticks-to-finish that arms the WaSP lookahead
  pages_per_prefetch_tick  promotion budget cap per tick
  async_prefetch           promote on a side stream, land at the next
                           tick-start barrier
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AssistSpec:
    """Which assist tasks run, where, and with what knobs."""
    kv: str = "bf16"
    paged: bool = False
    attn_backend: str = "gather"
    page_size: int = 16
    hbm_budget_mb: float = 64.0
    hbm_budget_bytes: Optional[int] = None
    hot_fraction: float = 0.5
    enable_warm: bool = True
    enable_cold: bool = True
    host_budget_bytes: Optional[int] = None
    max_cold_pages: Optional[int] = None
    cold_delta: bool = True
    use_roofline_trigger: bool = True
    prefetch_lookahead: int = 2
    pages_per_prefetch_tick: int = 2
    async_prefetch: bool = True

    def __post_init__(self):
        if self.kv not in ("bf16", "int8"):
            raise ValueError(f"kv must be bf16|int8, got {self.kv!r}")

    @property
    def budget_bytes(self) -> int:
        if self.hbm_budget_bytes is not None:
            return int(self.hbm_budget_bytes)
        return int(self.hbm_budget_mb * 2 ** 20)
