"""Declarative serving configuration: ServeConfig + AssistSpec -> engine.

Counterpart of ``repro.serving.config`` without the fields whose modules
are not ported (interpret mode, prefix reuse, sessions, faults,
observability).  ``paged=False`` builds the dense ``Engine``, whose cache
mode is ``kv_mode`` (bf16 | int8); ``paged=True`` the ``PagedEngine``.
The cold tier's knobs live in the nested ``AssistSpec``; ``kv_mode`` and
``max_cold_pages`` are also flat aliases, as in the reference.  ``device``
names where the engine runs: the card unless the caller passes ``"cpu"``.
The flat fields fold into an ``AssistSpec`` when none is passed; an
explicit spec is authoritative and back-fills them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.assist import AssistSpec
from repro_torch.configs.base import DEFAULT_EOS_ID


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Declarative serving configuration (CLI flags map 1:1)."""
    arch: str
    reduced: bool = False
    requests: int = 8
    slots: int = 4                  # decode lanes
    max_len: int = 128
    max_new: int = 12
    seed: int = 0
    eos_id: int = DEFAULT_EOS_ID
    kv_mode: str = "bf16"           # dense engine cache mode (bf16 | int8)
    paged: bool = False
    page_size: int = 16
    hbm_budget_mb: float = 64.0
    attn_backend: str = "gather"
    max_cold_pages: Optional[int] = None   # None = from the budgets
    device: Optional[str] = None    # None = the card
    assist: Optional[AssistSpec] = None

    def __post_init__(self):
        if self.assist is None:
            object.__setattr__(self, "assist", AssistSpec(
                kv=self.kv_mode, paged=self.paged,
                attn_backend=self.attn_backend, page_size=self.page_size,
                hbm_budget_mb=self.hbm_budget_mb,
                max_cold_pages=self.max_cold_pages))
        else:
            spec = self.assist
            for field, value in (("kv_mode", spec.kv),
                                 ("paged", spec.paged),
                                 ("page_size", spec.page_size),
                                 ("hbm_budget_mb",
                                  spec.budget_bytes / 2 ** 20),
                                 ("attn_backend", spec.attn_backend),
                                 ("max_cold_pages", spec.max_cold_pages)):
                object.__setattr__(self, field, value)

    def tier_config(self):
        """The paged cache's TierConfig, from the assist spec."""
        from repro_torch.cache import TierConfig
        spec = self.assist
        return TierConfig(page_size=spec.page_size,
                          hbm_budget_bytes=spec.budget_bytes,
                          hot_fraction=spec.hot_fraction,
                          enable_warm=spec.enable_warm,
                          enable_cold=spec.enable_cold,
                          host_budget_bytes=spec.host_budget_bytes,
                          prefetch_lookahead=spec.prefetch_lookahead,
                          pages_per_prefetch_tick=spec.pages_per_prefetch_tick,
                          cold_delta=spec.cold_delta,
                          async_prefetch=spec.async_prefetch)

    def build(self, model=None, params=None):
        """(engine, model, params) for this config.  Weights not passed in
        are drawn on the device from a generator seeded with ``seed``."""
        import torch

        from repro_torch import resolve_device
        device = resolve_device(self.device)
        if model is None:
            from repro_torch.configs import get_arch, reduced as reduce_cfg
            from repro_torch.models.model import build_model
            cfg = get_arch(self.arch)
            if self.reduced:
                cfg = reduce_cfg(cfg)
            if not cfg.causal:
                raise SystemExit(f"{cfg.name} is encoder-only: no serving "
                                 f"path")
            model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(self.seed)
            params = model.init(gen)
        from repro_torch.serving.engine import EngineBase
        return EngineBase.from_config(self, model, params), model, params
