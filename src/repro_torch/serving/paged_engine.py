"""Paged serving engine: block tables over the hot/warm tiered KV cache.

Counterpart of ``repro.serving.paged_engine`` trimmed to admission, decode
lanes, parking by demotion, the tick and retirement:

* decode state lives in fixed-size pages owned by ``repro_torch.cache``;
  ``lanes`` bounds how many requests decode per tick, while residency is
  bounded by the device-memory budget: requests beyond the lane count are
  prefilled into pages and parked, their pages demoted hot -> warm by LRU
  (preemption by demotion instead of rejection);
* the roofline trigger (``cache/policy.py``) decides whether demotion is
  allowed at all; a full warm tier spills its LRU pages to the packed host
  cold tier, and the WaSP lookahead queues a parked request's cold pages
  for promotion while the lanes ahead of it finish;
* promotions queued by the lookahead decode on a side stream and land at
  the tick-start barrier (``store.commit_promotions``), or earlier when a
  page is read this tick (``store.commit_page``).

The tick does not wait for the device, and every ordering the reference
got from JAX's data dependencies is explicit here:

* sampling runs on the device; the sampled tokens feed the next tick
  without visiting the host;
* the block table and the token vector stay on the device between ticks
  and are updated only in the rows whose lane assignment or page
  placement changed (indexed assignment of the real rows; the reference's
  out-of-range padding with ``mode="drop"`` has no counterpart);
* every upload (dirty rows, lengths, temperatures) is staged in pinned
  host memory (``repro_torch.to_device``), so queuing it does not wait
  for the device;
* the harvest lags one tick: each tick's tokens are copied into a pinned
  host buffer with ``non_blocking=True`` and a CUDA event is recorded; the
  next tick waits on that event before it reads the buffer, so the host
  never waits for the tick it just launched (the time it does wait is
  counted in ``harvest_wait_s``).  EOS discovery therefore lags one tick
  (the lane decodes one junk token that the harvest discards);
* the pools, the block table and the token vector are updated in place,
  and only on the current stream, so every read of them (the decode step,
  a later mover, the harvest copy) is ordered after the writes before it.

Prompt lengths bucket to page-size multiples rounded up to powers of two.
Prefix reuse, sessions, resilience and tracing of the reference are not
ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.assist import H100_SXM, AssistController, HardwareSpec
from repro_torch.cache import (TIER_COLD, TIER_WARM, BlockPool,
                               CachePolicy, TierConfig, TieredKVStore,
                               decode_roofline_terms)
from repro_torch.cache.block_pool import PoolExhausted
from repro_torch.cache.policy import kv_site, warm_ratio
from repro_torch.configs.base import DEFAULT_EOS_ID
from repro_torch.models import transformer as T
from repro_torch.models.model import ModelFns
from repro_torch.obs.metrics import TOKENS_BUCKETS, MetricsRegistry
from repro_torch.serving.engine import EngineBase, Request, _Readback


@dataclasses.dataclass
class _RState:
    """A resident request: tokens whose KV is cached (including the one in
    flight), its latest sampled token (a device scalar until harvested),
    and its remaining token budget."""
    req: Request
    length: int
    last_tok: Union[int, torch.Tensor]
    remaining: int


class PagedEngine(EngineBase):
    """Continuous batching over a paged, tiered KV cache."""

    def __init__(self, model: ModelFns, params, *, lanes: int, max_len: int,
                 tier: Optional[TierConfig] = None,
                 eos_id: int = DEFAULT_EOS_ID, seed: int = 0,
                 use_roofline_trigger: bool = True,
                 backend: str = "gather", hw: HardwareSpec = H100_SXM,
                 max_cold_pages: Optional[int] = None, device=None):
        cfg = model.cfg
        T.check_supported(cfg)
        self.device = resolve_device(device)
        self.model, self.params, self.cfg = model, params, cfg
        self.backend = backend
        tier = tier or TierConfig()
        if max_len % tier.page_size:
            raise ValueError("max_len must be a multiple of page_size")
        self.max_len, self.eos_id = max_len, eos_id
        self.n_lanes = lanes
        self.maxp = max_len // tier.page_size
        self.segments = T.paged_segments(cfg)
        geom = T.paged_geometry(cfg, tier.page_size)
        self.geom = geom
        hot, warm = tier.split_pages(geom.hot_page_bytes,
                                     geom.warm_page_bytes)
        if max_cold_pages is None:
            max_cold_pages = 0
            if tier.enable_cold:
                max_cold_pages = (
                    tier.host_budget_bytes // geom.warm_page_bytes
                    if tier.host_budget_bytes else 8 * (hot + warm))
        num_pages = hot + warm + max_cold_pages
        # one registry threads through pool, store, policy and engine
        self.metrics = m = MetricsRegistry()
        self.pool = BlockPool(num_pages, tier.page_size, metrics=m)
        self.store = TieredKVStore(geom, num_pages, hot_pages=hot,
                                   warm_pages=warm, device=self.device,
                                   host_budget_bytes=tier.host_budget_bytes,
                                   cold_delta=tier.cold_delta, metrics=m)
        terms = site = None
        if use_roofline_trigger:
            # resident tokens the hot tier can hold, at the exact per-token
            # bytes of this stack's pages
            resident_est = hot * tier.page_size
            per_tok = geom.hot_page_bytes / tier.page_size
            terms = decode_roofline_terms(cfg, lanes, resident_est,
                                          kv_bytes=per_tok, hw=hw)
            site = kv_site(cfg, resident_est, kv_bytes=per_tok)
        self.policy = CachePolicy(tier,
                                  controller=AssistController(hw=hw,
                                                              metrics=m),
                                  terms=terms, site=site,
                                  measured_ratio=warm_ratio(cfg.head_dim),
                                  metrics=m)

        self._c_tokens = m.counter("engine_tokens_generated_total",
                                   "decode tokens harvested")
        self._c_preempt = m.counter(
            "engine_preemptions_total",
            "lane preemptions (resident request demoted back to parked)")
        self._c_admit = m.counter("engine_admissions_total",
                                  "requests admitted (prefilled)")
        self._c_retire = m.counter("engine_retirements_total",
                                   "requests retired (EOS or budget)")
        self._c_wait = m.counter(
            "engine_harvest_wait_seconds_total",
            "host seconds spent waiting for the lagged harvest's copy")
        self._c_warm_reads = m.counter(
            "engine_warm_page_reads_total",
            "warm (negative) block-table entries of active lanes per tick")
        self._h_bucket = m.histogram(
            "engine_prefill_bucket_tokens",
            "padded prompt-bucket length per prefill", TOKENS_BUCKETS)
        self._g_lanes = m.gauge("engine_lanes_active",
                                "lanes decoding this tick")
        self._g_resident = m.gauge("engine_resident_tokens",
                                   "tokens whose decode state is cached")

        self.lanes: list[Optional[int]] = [None] * lanes
        self.resident: dict[int, _RState] = {}
        self.parked: collections.deque[int] = collections.deque()
        self.queue: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._init_intake(metrics=m)
        self.tick_no = 0
        self.peak_resident_tokens = 0
        self.tokens_generated = 0

        # device-resident per-lane tick state + host mirrors; a dirty row
        # is rebuilt on the host and written into the device copy
        self._bt_host = np.zeros((lanes, self.maxp), np.int32)
        self._bt_dev = torch.zeros((lanes, self.maxp), dtype=torch.int32,
                                   device=self.device)
        self._tokens_dev = torch.zeros((lanes,), dtype=torch.int32,
                                       device=self.device)
        self._lengths = np.zeros(lanes, np.int32)
        self._temps = np.zeros(lanes, np.float32)
        self._dirty_bt: set[int] = set()
        self._dirty_tok: set[int] = set()
        self._inflight: Optional[tuple] = None    # (_Readback, snapshot)
        self._pending_first: list = []            # [(req, _Readback)]

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req: Request):
        if len(req.prompt) + req.max_new > self.max_len:
            self._c_rejected.inc()
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + max_new "
                f"({req.max_new}) exceeds max_len ({self.max_len})")
        super().submit(req)

    def resident_tokens(self) -> int:
        return sum(r.length for r in self.resident.values())

    def _touch(self, rid: int):
        self.pool.touch(rid, self.tick_no)

    def _protected(self) -> set[int]:
        """Pages this tick's decode will touch (lane requests)."""
        prot: set[int] = set()
        for rid in self.lanes:
            if rid is not None:
                prot.update(self.pool.table(rid))
        return prot

    def _prefill(self, batch, req: Request):
        """Bucketed prefill -> (first sampled token int32[1] on the device,
        per-segment (k, v) [stack, G, S_pad, dh])."""
        ps = self.pool.page_size
        pad_to = -(-batch["tokens"].shape[1] // ps) * ps
        logits, state = self.model.prefill(self.params, batch, pad_to)
        last = logits[:, len(req.prompt) - 1]
        temps = torch.full((1,), float(req.temperature), device=self.device)
        tok = self._select_token(last, temps, req.temperature > 0.0)
        kv = [(state["scan"][j]["k"][:, 0], state["scan"][j]["v"][:, 0])
              for j, _ in enumerate(self.segments)]
        return tok, kv

    # -- lane bookkeeping (device-resident tick state) -----------------------

    def _assign(self, i: int, rid: int):
        """Put ``rid`` into lane ``i``; the row rebuild and token injection
        happen in the pre-dispatch update."""
        self.lanes[i] = rid
        self._dirty_bt.add(i)
        self._dirty_tok.add(i)

    def _vacate(self, i: int):
        """Empty lane ``i``: its row reads the trash page and its write
        lands there until the lane is reassigned."""
        self.lanes[i] = None
        self._bt_host[i, :] = 0
        self._lengths[i] = 0
        self._temps[i] = 0.0
        self._dirty_bt.add(i)
        self._dirty_tok.discard(i)

    def _push_lane_updates(self):
        """Write the dirty block-table rows and injected tokens into the
        device copies (nothing is sent on a steady tick)."""
        moved = self.store.drain_dirty()
        if moved:
            lane_of = {rid: i for i, rid in enumerate(self.lanes)
                       if rid is not None}
            for pid in moved:
                for rid in self.pool.owners_of(pid):
                    i = lane_of.get(rid)
                    if i is not None:
                        self._dirty_bt.add(i)
        if self._dirty_bt:
            idx = sorted(self._dirty_bt)
            for i in idx:
                rid = self.lanes[i]
                if rid is not None:
                    st = self.resident[rid]
                    table = self.pool.table(rid)
                    self._bt_host[i, :] = 0
                    self._bt_host[i, :len(table)] = \
                        [self.store.encoded_loc(p) for p in table]
                    self._lengths[i] = st.length
                    self._temps[i] = st.req.temperature
            self._bt_dev[to_device(np.array(idx, np.int64), self.device)] = \
                to_device(self._bt_host[idx], self.device)
            self._dirty_bt.clear()
        if self._dirty_tok:
            idx = sorted(self._dirty_tok)
            vals = []
            for i in idx:
                tok = self.resident[self.lanes[i]].last_tok
                vals.append(tok.reshape(1) if isinstance(tok, torch.Tensor)
                            else to_device(np.array([tok], np.int32),
                                           self.device))
            self._tokens_dev[to_device(np.array(idx, np.int64),
                                       self.device)] = torch.cat(vals)
            self._dirty_tok.clear()

    # -- admission (preemption by demotion, never rejection) -----------------

    def _admit_one(self, req: Request, protected: set[int]) -> bool:
        plen = len(req.prompt)
        npg = self.pool.pages_for(plen)
        if npg > self.pool.n_free:
            return False
        if npg and not self.policy.make_hot_room(self.pool, self.store,
                                                 protected, n=npg):
            return False
        pages = self.pool.allocate(req.rid, npg)
        slots = [self.store.place_hot(p) for p in pages]
        batch = self._pad_prompt(req.prompt, self.pool.page_size)
        tok, kv = self._prefill(batch, req)
        self.store.write_prefill(slots, kv, S=plen)
        # the first token stays on the device; the harvest appends it
        self.resident[req.rid] = _RState(req, plen, tok[0], req.max_new - 1)
        self._pending_first.append((req, _Readback(tok)))
        self._c_admit.inc()
        self._touch(req.rid)
        self.peak_resident_tokens = max(self.peak_resident_tokens,
                                        self.resident_tokens())
        return True

    def _ensure_decodable(self, rid: int, protected: set[int]) -> bool:
        """All of rid's pages readable and its write page hot; may allocate
        the next page at a page boundary, and swaps the request's cold
        pages in as one batch.  One batched mover episode."""
        with self.store.deferred():
            st = self.resident[rid]
            table = self.pool.table(rid)
            protected.update(table)
            need = self.pool.pages_for(st.length + 1)
            while len(table) < need:
                if self.pool.n_free < 1 or not self.policy.make_hot_room(
                        self.pool, self.store, protected):
                    return False
                pid = self.pool.allocate(rid, 1)[0]
                self.store.place_hot(pid)
                protected.add(pid)
                table = self.pool.table(rid)
            cold = [p for p in table if self.store.tier[p] == TIER_COLD]
            if cold:
                # swap-in: the whole cold run promotes in one batch
                if not self.policy.make_warm_room(self.pool, self.store,
                                                  protected, n=len(cold)):
                    return False
                if len(self.store.promote_many(cold)) != len(cold):
                    return False
            for pid in table:
                if self.store.tier[pid] != TIER_COLD:
                    # promoted asynchronously this tick (after the barrier):
                    # land it before the decode reads it
                    self.store.commit_page(pid)
            wp = table[st.length // self.pool.page_size]
            if self.store.tier[wp] == TIER_WARM:
                if not self.policy.make_hot_room(self.pool, self.store,
                                                 protected):
                    return False
                self.store.promote_to_hot(wp)
            return True

    def _fill_lanes(self, protected: set[int]):
        for i, rid in enumerate(self.lanes):
            if rid is not None:
                continue
            # parked residents first (FIFO), then fresh admissions; walk
            # past stuck candidates so they cannot starve the rest
            skipped: list[int] = []
            while self.parked:
                cand = self.parked.popleft()
                if cand not in self.resident:
                    continue
                pages = list(self.pool.table(cand))
                cold_before = [p for p in pages
                               if self.store.tier[p] == TIER_COLD]
                if self._ensure_decodable(cand, protected):
                    # scored once, on the attempt that swaps in
                    self.policy.account_swap_in(pages, cold_before)
                    self._assign(i, cand)
                    break
                skipped.append(cand)
            self.parked.extendleft(reversed(skipped))
            if self.lanes[i] is not None or not self.queue:
                continue
            req = self.queue[0]
            try:
                ok = self._admit_one(req, protected)
            except PoolExhausted:
                ok = False
            if ok:
                self.queue.popleft()
                if self._ensure_decodable(req.rid, protected):
                    self._assign(i, req.rid)
                else:
                    self.parked.append(req.rid)

    def _admit_extra(self, protected: set[int]):
        """Admit beyond the lane count: prefill into pages and park."""
        while self.queue:
            req = self.queue[0]
            try:
                ok = self._admit_one(req, protected)
            except PoolExhausted:
                ok = False
            if not ok:
                return
            self.queue.popleft()
            self.parked.append(req.rid)

    # -- main loop -----------------------------------------------------------

    def step(self) -> bool:
        """One tick: land last tick's prefetch promotions, promote queued
        cold pages, schedule and admit, decode (sampling on the device),
        harvest the PREVIOUS tick's tokens while this one runs, then queue
        the next parked requests' cold pages (WaSP lookahead)."""
        self.tick_no += 1
        # drain barrier: nothing reads the warm pool before this
        self.store.commit_promotions()
        protected = self._protected()
        self.policy.drain_prefetch(self.pool, self.store, protected)
        self._fill_lanes(protected)
        for i, rid in enumerate(self.lanes):
            if rid is not None and not self._ensure_decodable(rid,
                                                              protected):
                self._vacate(i)                    # preempt by demotion
                self.parked.appendleft(rid)
                self._c_preempt.inc()
        self._admit_extra(protected)
        active = [i for i, rid in enumerate(self.lanes) if rid is not None]
        self._g_lanes.set(len(active))
        if not active:
            prev, self._inflight = self._inflight, None
            return self._harvest(prev)

        self._push_lane_updates()
        self.store.flush_movers()      # pending tier copies precede the read
        self._c_warm_reads.inc(int((self._bt_host[active] < 0).sum()))
        lengths = to_device(self._lengths, self.device)
        temps = to_device(self._temps, self.device)
        logits, _ = self.model.paged_decode_step(
            self.params, self.store.pools, self._tokens_dev[:, None],
            self._bt_dev, lengths, has_warm=self.store.warm_pages > 0,
            backend=self.backend)
        nxt = self._select_token(logits[:, 0], temps,
                                 bool((self._temps > 0.0).any()))
        self._tokens_dev = nxt

        snapshot = []
        closing = 0
        for i in active:
            rid = self.lanes[i]
            st = self.resident[rid]
            st.length += 1                  # host-known: the write position
            self._lengths[i] += 1
            st.remaining -= 1               # budget advance at dispatch
            snapshot.append((i, rid, st.remaining))
            if st.remaining <= 0:
                # budget exhausted: free the lane now; the final token is
                # in flight and retires at the next harvest
                self._vacate(i)
            if st.remaining <= self.policy.cfg.prefetch_lookahead:
                closing += 1
        res = self.resident_tokens()
        self.peak_resident_tokens = max(self.peak_resident_tokens, res)
        self._g_resident.set(res)
        prev, self._inflight = self._inflight, (_Readback(nxt), snapshot)
        self._harvest(prev)
        # WaSP lookahead: start promoting the next parked requests' cold
        # pages while the closing lanes finish
        for rid in list(self.parked)[:closing]:
            cold = [p for p in self.pool.table(rid)
                    if self.store.tier[p] == TIER_COLD]
            if cold:
                self.policy.schedule_prefetch(cold, kind="lookahead")
        return True

    def _harvest(self, prev) -> bool:
        """Land the lagged tokens: append to output streams, update
        last_tok, retire EOS/out-of-budget requests."""
        firsts, self._pending_first = self._pending_first, []
        if prev is None and not firsts:
            return False
        for req, rb in firsts:
            tok = int(self._wait(rb)[0])
            req.out.append(tok)
            st = self.resident.get(req.rid)
            if st is not None and isinstance(st.last_tok, torch.Tensor):
                st.last_tok = tok
        if prev is not None:
            rb, snapshot = prev
            nxt = self._wait(rb)
            for i, rid, rem in snapshot:
                st = self.resident.get(rid)
                if st is None:
                    continue              # retired earlier: junk past EOS
                tok = int(nxt[i])
                st.req.out.append(tok)
                st.last_tok = tok
                self.tokens_generated += 1
                self._c_tokens.inc()
                self._touch(rid)
                if rem <= 0 or tok == self.eos_id:
                    self._retire(rid)
        return True

    def _retire(self, rid: int):
        st = self.resident.pop(rid)
        st.req.done = True
        self.finished.append(st.req)
        self._c_retire.inc()
        for i, r in enumerate(self.lanes):
            if r == rid:
                self._vacate(i)
        freed = self.pool.free_request(rid)
        for pid in freed:
            self.store.release(pid)
        self.policy.forget_pages(freed)

    def sync(self):
        """Wait until every launched tick, prefill and mover has run."""
        self.store.flush_movers()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, max_ticks: int = 10_000):
        """Drive ticks until done.  Requests still queued at the end do not
        fit the configured budgets and are left for the caller."""
        ticks = 0
        while (self.queue or self.resident or self._inflight is not None
               or self._pending_first) and ticks < max_ticks:
            if not self.step():
                break
            ticks += 1
        return self.finished

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        gv = self.metrics.get_value
        return {"tick": self.tick_no,
                "backend": self.backend,
                "queued": len(self.queue),
                "parked": len(self.parked),
                "resident_tokens": self.resident_tokens(),
                "peak_resident_tokens": self.peak_resident_tokens,
                "tokens_generated": self.tokens_generated,
                "preemptions": gv("engine_preemptions_total") or 0,
                "admissions": gv("engine_admissions_total") or 0,
                "warm_page_reads": gv("engine_warm_page_reads_total") or 0,
                "harvest_wait_s": gv("engine_harvest_wait_seconds_total"),
                "hbm_bytes_used": self.store.hbm_bytes_used(),
                "cold_bytes": self.store.cold_bytes,
                "tiers": self.store.tier_counts(),
                "hot_pages": self.store.hot_pages,
                "warm_pages": self.store.warm_pages,
                "pool": dataclasses.asdict(self.pool.stats),
                "store": dict(self.store.stats),
                "policy": dict(self.policy.stats),
                "cold": self.store.cold_stats(),
                "trigger": (dataclasses.asdict(self.policy.decision)
                            if self.policy.decision else None)}
