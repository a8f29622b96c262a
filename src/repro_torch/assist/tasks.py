"""Planning vocabulary of the assist tasks, and the cold-page prefetch task.

Counterpart of ``repro.assist.tasks``: a ``SiteDescriptor`` (what an assist
site moves), ``RooflineTerms`` (the modeled step), an ``AssistDecision``
(the controller's verdict), ``CompressTask`` (a scheme and its cost
traits) and ``PrefetchTask`` (the WaSP lookahead queue that promotes cold
pages warm-ward ahead of a swap-in).  The hardware constants the reference
keeps at module level are a ``HardwareSpec`` parameter here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Rates the roofline model divides by."""
    name: str
    peak_flops: float      # dense bf16 matrix rate, FLOP/s
    hbm_bw: float          # device memory, bytes/s
    ici_bw: float          # one inter-chip link, bytes/s
    vpu_ops: float         # elementwise (dequantize) operations/s
    host_bw: float         # host -> device copies (prefetch), bytes/s


#: NVIDIA H100 SXM, from NVIDIA's data sheet: published peaks, not measured
#: on any card (bf16 dense tensor-core rate, HBM3 bandwidth, one direction
#: of NVLink, the FP32 CUDA-core rate for the elementwise dequantize, one
#: direction of PCIe Gen5 x16).
H100_SXM = HardwareSpec("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                        ici_bw=450e9, vpu_ops=67e12, host_bw=64e9)

#: The reference's TPU v5e constants (repro.assist.tasks), for parity runs
#: whose decisions must match the reference's.
TPU_V5E = HardwareSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       ici_bw=50e9, vpu_ops=4 * 8 * 128 * 940e6,
                       host_bw=16e9)

MIN_RATIO = 1.2           # paper 6: require 20% compressibility

KINDS = ("compress", "memoize", "prefetch")


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-device seconds for one step."""
    compute: float
    memory: float
    collective: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute, "memory": self.memory,
                 "collective": self.collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        # perfect-overlap lower bound: the dominant term
        return max(self.compute, self.memory, self.collective)


@dataclasses.dataclass(frozen=True)
class SiteDescriptor:
    """One assist opportunity in a step: ``term`` is the roofline term the
    task relieves, ``bytes_per_step`` what the site moves per step."""
    name: str
    bytes_per_step: float
    term: str
    lossless_required: bool
    measured_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class AssistDecision:
    """The controller's verdict for one (task, site) pair."""
    site: str
    enabled: bool
    scheme: str
    ratio: float
    reason: str
    kind: str = "compress"
    budget: int = 0        # prefetch: pages the throttle allows per tick


@dataclasses.dataclass(frozen=True)
class CompressTask:
    """One registered compression scheme: its codec (where the port has
    one) and its cost traits.  ``jit_compress``: fixed-rate, so usable
    inside a traced step (the reference's trait).  ``host``: the codec
    takes and gives host numpy arrays (the cold tier's packed codecs);
    otherwise tensors, on their device."""
    name: str
    decomp_ops_per_byte: float
    compress: Optional[Callable[..., Any]] = None
    decompress: Optional[Callable[[Any], Any]] = None
    lossless: bool = False
    jit_compress: bool = False
    host: bool = False

    kind = "compress"


# ---------------------------------------------------------------------------
# prefetch (paper 8.2): the cold-page promotion queue
# ---------------------------------------------------------------------------

class PrefetchTask:
    """Cold->warm page prefetch queue (the WaSP lookahead, paper 8.2).

    ``schedule`` enqueues the cold pages of a soon-to-run request;
    ``apply`` drains up to the throttled page budget, promoting through
    the provided store; ``account_swap_in`` scores the outcome.

    Every ISSUED page (entered the queue) resolves to exactly one of

      hit     promoted ahead of the swap-in that needed it
      late    needed while still cold (blocking promotion) or resident
              via some other path -- prefetch didn't deliver in time
      wasted  promoted (or queued) but freed / demoted back to cold
              before any swap-in used it

    through the ``_outstanding`` set, so ``issued == hit + late + wasted +
    outstanding`` always holds.  ``counters`` gives the reference's key
    names; ``prefetch_misses`` counts every cold page at swap-in, issued
    or not.
    """

    kind = "prefetch"

    def __init__(self, name: str = "coldpage", *, pages_per_tick: int = 2,
                 async_promote: bool = True, metrics=None,
                 controller=None):
        self.name = name
        self.pages_per_tick = pages_per_tick
        self.async_promote = async_promote
        # the consumer's controller (CachePolicy threads its own in); None
        # falls back to a default controller per plan() call
        self.controller = controller
        self._queue: list[int] = []         # page ids queued cold->warm
        self._prefetched: set[int] = set()  # promoted ahead of swap-in
        self._outstanding: set[int] = set() # issued, outcome not yet known
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c = {o: self.metrics.counter(
            "prefetch_pages_total",
            "prefetch pages by outcome (issued == hit + late + wasted "
            "once outstanding drains)", outcome=o)
            for o in ("issued", "hit", "late", "wasted")}
        self._c_cold_miss = self.metrics.counter(
            "prefetch_cold_misses_total",
            "cold pages at swap-in (issued or not)")
        self._g_queue = self.metrics.gauge(
            "prefetch_queue_depth", "pages queued for cold->warm promotion")
        self._c_kind: dict = {}

    def _issued_kind(self, kind: str):
        c = self._c_kind.get(kind)
        if c is None:
            c = self._c_kind[kind] = self.metrics.counter(
                "prefetch_issued_total",
                "pages entering the prefetch queue, by consumer kind",
                kind=kind)
        return c

    @property
    def counters(self) -> dict:
        """Counter view under the reference's key names."""
        gv = self.metrics.get_value
        return {
            "prefetch_issued": gv("prefetch_pages_total",
                                  outcome="issued") or 0,
            "prefetch_hits": gv("prefetch_pages_total", outcome="hit") or 0,
            "prefetch_misses": gv("prefetch_cold_misses_total") or 0,
            "prefetch_late": gv("prefetch_pages_total", outcome="late") or 0,
            "prefetch_wasted": gv("prefetch_pages_total",
                                  outcome="wasted") or 0,
            "prefetch_outstanding": len(self._outstanding),
        }

    def build(self, **overrides) -> "PrefetchTask":
        """Fresh queue instance (the registry holds a prototype)."""
        kw = dict(pages_per_tick=self.pages_per_tick,
                  async_promote=self.async_promote,
                  controller=self.controller)
        kw.update(overrides)
        return PrefetchTask(self.name, **kw)

    def plan(self, site: SiteDescriptor,
             roofline: Optional[RooflineTerms]) -> AssistDecision:
        ctl = self.controller
        if ctl is None:
            from repro_torch.assist.controller import AssistController
            ctl = AssistController()
        return ctl.decide_prefetch(roofline, site, queued=len(self._queue),
                                   max_pages=self.pages_per_tick)

    def schedule(self, page_ids, kind: str = "lookahead"):
        """Queue cold pages of a soon-to-run request for promotion; ``kind``
        names the producer on ``prefetch_issued_total{kind=}``."""
        c_kind = self._issued_kind(kind)
        for p in page_ids:
            if p not in self._queue and p not in self._outstanding:
                self._queue.append(p)
                self._c["issued"].inc()
                c_kind.inc()
                self._outstanding.add(p)
        self._g_queue.set(len(self._queue))

    def apply(self, store, protected, make_warm_room, *,
              is_cold, budget: Optional[int] = None):
        """Drain up to ``budget`` queued pages through the store.

        ``make_warm_room(protected)`` frees a warm slot (policy-owned);
        ``is_cold(pid)`` reports residency so stale entries are dropped."""
        if budget is None:
            budget = self.pages_per_tick
        try:
            while budget > 0 and self._queue:
                pid = self._queue[0]
                if not is_cold(pid):              # already resident / freed
                    self._queue.pop(0)
                    continue
                if store.n_free_warm == 0 and not make_warm_room(protected):
                    return
                self._queue.pop(0)
                store.promote_to_warm(pid, async_=self.async_promote)
                self._prefetched.add(pid)
                budget -= 1
        finally:
            self._g_queue.set(len(self._queue))

    def account_swap_in(self, page_ids, cold_page_ids):
        """Called once per successful swap-in of a parked request: pages
        the queue promoted ahead of time are hits; issued pages it did not
        deliver resolve as late."""
        cold = set(cold_page_ids)
        self._c_cold_miss.inc(len(cold))
        for p in page_ids:
            if p not in cold and p in self._prefetched:
                self._c["hit"].inc()
                self._prefetched.discard(p)
                self._outstanding.discard(p)
            elif p in self._outstanding:
                self._c["late"].inc()
                self._outstanding.discard(p)
                if p in self._queue:
                    self._queue.remove(p)
        self._g_queue.set(len(self._queue))

    def forget_pages(self, page_ids):
        """Drop freed pages so recycled page ids can never count as hits
        for another request; issued pages freed unused are wasted."""
        for p in page_ids:
            self._prefetched.discard(p)
            if p in self._queue:
                self._queue.remove(p)
            if p in self._outstanding:
                self._c["wasted"].inc()
                self._outstanding.discard(p)
        self._g_queue.set(len(self._queue))

    def discard_prefetched(self, pid):
        """A page demoted back to cold is no longer a usable prefetch: the
        promotion resolves as wasted (still-queued pages stay outstanding)."""
        if pid in self._prefetched:
            self._prefetched.discard(pid)
            self._outstanding.discard(pid)
            self._c["wasted"].inc()
