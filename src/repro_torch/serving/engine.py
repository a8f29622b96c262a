"""Request intake and on-device sampling shared by the serving engines.

Counterpart of ``repro.serving.engine`` as far as the paged engine needs
it: ``Request``, and ``EngineBase`` with intake, the fused token select
and bucket-padded prompts.  The dense ``Engine`` is not ported yet;
``EngineBase.from_config`` builds the paged engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.models.model import prompt_bucket
from repro_torch.obs.metrics import NULL_REGISTRY


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list            # token ids
    max_new: int = 16
    temperature: float = 0.0
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class EngineBase:
    """Request intake + sampling.  Subclasses provide ``self.queue``,
    ``self.finished``, ``self.device``, ``self.gen``, ``self.max_len`` and
    ``self._h_bucket``, and call ``_init_intake()`` from the constructor."""

    @classmethod
    def from_config(cls, scfg, model, params) -> "EngineBase":
        """Build the engine a ServeConfig describes (paged only here)."""
        spec = scfg.assist
        if not spec.paged:
            raise NotImplementedError("the dense Engine is not yet ported; "
                                      "serve with paged=True (--paged)")
        from repro_torch.serving.paged_engine import PagedEngine
        return PagedEngine(model, params, lanes=scfg.slots,
                           max_len=scfg.max_len, tier=scfg.tier_config(),
                           eos_id=scfg.eos_id, seed=scfg.seed,
                           backend=spec.attn_backend,
                           use_roofline_trigger=spec.use_roofline_trigger,
                           max_cold_pages=spec.max_cold_pages,
                           device=scfg.device)

    def _init_intake(self, metrics=None):
        self._seen_rids: set[int] = set()
        self._next_rid = 0
        m = metrics if metrics is not None else NULL_REGISTRY
        self._g_qdepth = m.gauge("engine_queue_depth",
                                 "requests waiting for admission")
        self._c_rejected = m.counter("engine_admission_rejected_total",
                                     "submissions rejected at intake",
                                     reason="oversize")

    def submit(self, req: Request):
        if req.rid in self._seen_rids:      # recycle colliding rids
            req.rid = self._next_rid
        self._seen_rids.add(req.rid)
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.queue.append(req)
        self._g_qdepth.set(len(self.queue))

    def _select_token(self, logits, temps, sampled: bool):
        """On-device greedy/categorical select.

        logits: f32[B, V]; temps: f32[B] (<= 0 means greedy).  ``sampled``
        (host-known: some lane has temperature > 0) adds Gumbel-max
        sampling from ``self.gen``; greedy rows never read it, so greedy
        streams do not depend on the generator.
        """
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if not sampled:
            return greedy
        t = torch.where(temps > 0.0, temps, torch.ones_like(temps))
        u = torch.rand(logits.shape, generator=self.gen, device=self.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        drawn = (logits / t[:, None] + gumbel).argmax(dim=-1).to(torch.int32)
        return torch.where(temps > 0.0, drawn, greedy)

    def _pad_prompt(self, prompt, quantum: int) -> dict:
        """Bucket-padded prefill batch: tokens padded up to the bucket,
        true_len carrying the real length."""
        plen = len(prompt)
        bucket = prompt_bucket(plen, self.max_len, quantum)
        self._h_bucket.observe(bucket)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = prompt
        return {"tokens": to_device(toks, self.device),
                "true_len": to_device(np.array([plen], np.int32),
                                      self.device)}
