"""AssistSpec: the declarative assist configuration of a deployment.

Counterpart of ``repro.assist.spec`` with the fields this port serves:
the paged KV cache, its attention backend and its hot/warm tier split.
The packed cold tier is not ported yet, so ``enable_cold`` defaults to
False and True raises.  The spec is configuration only: it imports no
cache or serving layer.

  paged                page the KV cache (the dense engine is not ported)
  attn_backend         paged decode attention (kernels/decode_attn/ops.py)
  page_size            tokens per page
  hbm_budget_mb        device-memory budget for the page pools (MiB)
  hbm_budget_bytes     exact-byte override of hbm_budget_mb
  hot_fraction         share of the budget kept bf16
  enable_warm          int8 warm tier (the CABA KV site)
  enable_cold          packed host cold tier (not ported: must be False)
  use_roofline_trigger let the controller's trigger gate demotion
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AssistSpec:
    """Which assist tasks run, where, and with what knobs."""
    paged: bool = False
    attn_backend: str = "gather"
    page_size: int = 16
    hbm_budget_mb: float = 64.0
    hbm_budget_bytes: Optional[int] = None
    hot_fraction: float = 0.5
    enable_warm: bool = True
    enable_cold: bool = False
    use_roofline_trigger: bool = True

    def __post_init__(self):
        if self.enable_cold:
            raise NotImplementedError("cold tier not yet ported")

    @property
    def budget_bytes(self) -> int:
        if self.hbm_budget_bytes is not None:
            return int(self.hbm_budget_bytes)
        return int(self.hbm_budget_mb * 2 ** 20)
