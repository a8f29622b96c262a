"""AssistController: the compress trigger and throttle (paper 4.3/4.4).

Counterpart of ``repro.assist.controller`` as far as the KV demotion verdict
goes: a site compresses only when the roofline term it relieves dominates
the step, its measured ratio clears the profitability floor, and the
modeled step (decompression added to compute, saved bytes taken off
memory) strictly improves.  The rates come from a ``HardwareSpec``.
"""
from __future__ import annotations

from typing import Union

from repro_torch.assist.tasks import (COMPRESS_TASKS, H100_SXM, KINDS,
                                      MIN_RATIO, AssistDecision,
                                      CompressTask, HardwareSpec,
                                      RooflineTerms, SiteDescriptor)
from repro_torch.obs.metrics import NULL_REGISTRY


class AssistController:
    """Compile-time AWC: trigger and throttle for compress sites."""

    def __init__(self, hw: HardwareSpec = H100_SXM,
                 min_ratio: float = MIN_RATIO, metrics=None):
        self.hw = hw
        self.min_ratio = min_ratio
        m = metrics if metrics is not None else NULL_REGISTRY
        self._c_decisions = {
            (k, v): m.counter("assist_decisions_total",
                              "controller verdicts per assist kind",
                              kind=k, verdict=v)
            for k in KINDS for v in ("accept", "reject")}

    @staticmethod
    def _task(scheme: Union[str, CompressTask]) -> CompressTask:
        return COMPRESS_TASKS[scheme] if isinstance(scheme, str) else scheme

    def decide(self, terms: RooflineTerms, site: SiteDescriptor,
               measured_ratio: float,
               scheme: Union[str, CompressTask]) -> AssistDecision:
        """Should this site compress?"""
        d = self._decide(terms, site, measured_ratio, scheme)
        self._c_decisions[(d.kind, "accept" if d.enabled
                           else "reject")].inc()
        return d

    def _decide(self, terms, site, measured_ratio, scheme):
        task = self._task(scheme)
        relieved = getattr(terms, site.term)
        if relieved < terms.step_time * 0.999:
            return AssistDecision(site.name, False, "raw", 1.0,
                                  f"{site.term} term is not the bottleneck "
                                  f"({relieved:.3e}s < {terms.step_time:.3e}s)")
        if measured_ratio < self.min_ratio:
            return AssistDecision(site.name, False, "raw", measured_ratio,
                                  f"compressibility {measured_ratio:.2f}x "
                                  f"below threshold {self.min_ratio}x "
                                  f"(paper 6 rule)")
        new_terms = self.modeled_terms(terms, site, measured_ratio, task)
        if new_terms.step_time >= terms.step_time * 0.999:
            return AssistDecision(site.name, False, "raw", measured_ratio,
                                  "throttled: decompression overhead would "
                                  "not improve the modeled bottleneck "
                                  "(paper 4.4)")
        return AssistDecision(site.name, True, task.name, measured_ratio,
                              f"{site.term}-bound and {measured_ratio:.2f}x "
                              f"compressible -> modeled step "
                              f"{terms.step_time:.3e}s -> "
                              f"{new_terms.step_time:.3e}s")

    def modeled_terms(self, terms: RooflineTerms, site: SiteDescriptor,
                      ratio: float,
                      scheme: Union[str, CompressTask]) -> RooflineTerms:
        """Roofline terms after enabling the site."""
        task = self._task(scheme)
        hw = self.hw
        saved = site.bytes_per_step * (1.0 - 1.0 / ratio)
        decomp_s = site.bytes_per_step * task.decomp_ops_per_byte / hw.vpu_ops
        memory = terms.memory - (saved / hw.hbm_bw
                                 if site.term == "memory" else 0.0)
        coll = terms.collective - (saved / hw.ici_bw
                                   if site.term == "collective" else 0.0)
        return RooflineTerms(terms.compute + decomp_s, max(memory, 0.0),
                             max(coll, 0.0))
