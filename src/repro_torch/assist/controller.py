"""AssistController: trigger and throttle of the compress and prefetch
tasks (paper 4.3/4.4).

Counterpart of ``repro.assist.controller`` for the KV cache's two tasks:
a site compresses only when the roofline term it relieves dominates the
step, its measured ratio clears the profitability floor, and the modeled
step (decompression added to compute, saved bytes taken off memory)
strictly improves; cold-page prefetch promotes only as many pages per tick
as host-to-device transfers hide inside one modeled step.  The rates come
from a ``HardwareSpec``.
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.assist.tasks import (H100_SXM, KINDS, MIN_RATIO,
                                      AssistDecision, CompressTask,
                                      HardwareSpec, RooflineTerms,
                                      SiteDescriptor)
from repro_torch.obs.metrics import NULL_REGISTRY


class AssistController:
    """Compile-time AWC: trigger and throttle for compress and prefetch."""

    def __init__(self, hw: HardwareSpec = H100_SXM,
                 min_ratio: float = MIN_RATIO, registry=None, metrics=None):
        if registry is None:
            from repro_torch.assist.registry import REGISTRY
            registry = REGISTRY
        self.registry = registry
        self.hw = hw
        self.min_ratio = min_ratio
        m = metrics if metrics is not None else NULL_REGISTRY
        self._c_decisions = {
            (k, v): m.counter("assist_decisions_total",
                              "controller verdicts per assist kind",
                              kind=k, verdict=v)
            for k in KINDS for v in ("accept", "reject")}

    def _task(self, scheme: Union[str, CompressTask]) -> CompressTask:
        return self.registry.get(scheme) if isinstance(scheme, str) \
            else scheme

    def _record(self, d: AssistDecision) -> AssistDecision:
        self._c_decisions[(d.kind, "accept" if d.enabled
                           else "reject")].inc()
        return d

    def decide(self, terms: RooflineTerms, site: SiteDescriptor,
               measured_ratio: float,
               scheme: Union[str, CompressTask]) -> AssistDecision:
        """Should this site compress?"""
        return self._record(self._decide(terms, site, measured_ratio,
                                         scheme))

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

    def decide_prefetch(self, terms: Optional[RooflineTerms],
                        site: SiteDescriptor, *, queued: int,
                        max_pages: int) -> AssistDecision:
        """How many queued cold pages may promote this tick?

        Prefetch is the lowest-priority assist work (paper 4.4): it only
        spends transfer time that hides inside the decode tick's shadow.
        ``site.bytes_per_step`` is one page's promotion payload; the budget
        is how many such host-to-device transfers fit in one modeled step
        (floor 1, so a queued page always makes progress)."""
        return self._record(self._decide_prefetch(terms, site, queued,
                                                  max_pages))

    def _decide_prefetch(self, terms, site, queued, max_pages):
        if queued == 0:
            return AssistDecision(site.name, False, "none", 1.0,
                                  "prefetch queue empty", kind="prefetch")
        if max_pages <= 0:
            return AssistDecision(site.name, False, "none", 1.0,
                                  "prefetch disabled (page budget 0)",
                                  kind="prefetch")
        if terms is None:
            return AssistDecision(site.name, True, "coldpage", 1.0,
                                  "no roofline given: configured budget",
                                  kind="prefetch", budget=max_pages)
        transfer_s = site.bytes_per_step / self.hw.host_bw
        fits = int(terms.step_time / max(transfer_s, 1e-30))
        budget = max(1, min(max_pages, fits))
        return AssistDecision(
            site.name, True, "coldpage", 1.0,
            f"{queued} queued; {fits} page transfer(s) hide inside one "
            f"{terms.step_time:.3e}s tick -> budget {budget}",
            kind="prefetch", budget=budget)
