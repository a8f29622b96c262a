"""Batched serving engine with continuous batching, and what both engines
share.

Counterpart of ``repro.serving.engine``: ``Request``; ``EngineBase`` with
intake, the fused token select and bucket-padded prompts (and
``from_config``, which builds the dense ``Engine`` or the
``PagedEngine``); and the dense ``Engine``.

The dense engine keeps a fixed pool of B slots over one decode state (a
[B, G, max_len, dh] cache per layer, bf16 or int8: ``kv_mode``).  New
requests are prefilled one at a time, padded to a bucketed length
(``PREFILL_QUANTUM * 2**k``) and masked by ``true_len``, and spliced in
place into a free slot; one decode step advances every slot per tick;
finished slots are recycled without stalling the rest.  The tick does not
wait for the device:

* sampling runs on the device; the sampled tokens feed the next tick
  without visiting the host;
* the harvest lags one tick: each tick's tokens are copied into a pinned
  host buffer with ``non_blocking=True`` and a CUDA event is recorded; the
  next tick waits on that event before it reads the buffer (the time it
  waits is counted in ``harvest_wait_s``).  EOS discovery therefore lags
  one tick: the slot decodes one junk token that the harvest discards;
* the cache, the lengths and the token vector are updated in place on
  the current stream, so every read of them is ordered after the writes
  before it.

Observability, the transfer guard and bounded-queue shedding of the
reference are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.configs.base import DEFAULT_EOS_ID
from repro_torch.models.model import ModelFns, prompt_bucket
from repro_torch.obs.metrics import (NULL_REGISTRY, TOKENS_BUCKETS,
                                     MetricsRegistry)


class _Readback:
    """A device->host copy of a small int tensor that the host reads later.

    On the card the copy goes into pinned memory with ``non_blocking=True``
    followed by an event; ``get`` waits on that event only.  On the CPU the
    tensor is cloned (later in-place updates of it must not show)."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


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
    ``self.finished``, ``self.device``, ``self.gen``, ``self.max_len``,
    ``self._h_bucket`` and ``self._c_wait``, and call ``_init_intake()``
    from the constructor."""

    @classmethod
    def from_config(cls, scfg, model, params) -> "EngineBase":
        """Build the engine a ServeConfig describes (dense or paged)."""
        spec = scfg.assist
        if not spec.paged:
            return Engine(model, params, batch_slots=scfg.slots,
                          max_len=scfg.max_len, kv_mode=spec.kv,
                          eos_id=scfg.eos_id, seed=scfg.seed,
                          device=scfg.device)
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

    def _wait(self, rb: _Readback) -> np.ndarray:
        """Read a lagged copy, counting the host's wait for it."""
        t0 = time.perf_counter()
        got = rb.get()
        self._c_wait.inc(time.perf_counter() - t0)
        return got

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


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    remaining: int = 0


class Engine(EngineBase):
    """Greedy/temperature sampling over a slot-batched dense decode state."""

    #: prompt-length bucket quantum (the paged engine buckets on its page
    #: size instead)
    PREFILL_QUANTUM = 16

    def __init__(self, model: ModelFns, params, *, batch_slots: int,
                 max_len: int, kv_mode: str = "bf16",
                 eos_id: int = DEFAULT_EOS_ID, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model, self.params, self.cfg = model, params, model.cfg
        self.B, self.max_len = batch_slots, max_len
        self.kv_mode, self.eos_id = kv_mode, eos_id
        self.metrics = m = MetricsRegistry()
        self._c_tokens = m.counter("engine_tokens_generated_total",
                                   "decode tokens harvested")
        self._c_wait = m.counter(
            "engine_harvest_wait_seconds_total",
            "host seconds spent waiting for the lagged harvest's copy")
        self._h_bucket = m.histogram(
            "engine_prefill_bucket_tokens",
            "padded prompt-bucket length per prefill", TOKENS_BUCKETS)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.state = model.init_state(batch_slots, max_len, kv_mode=kv_mode,
                                      device=self.device)
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []
        self._temps = np.zeros(batch_slots, np.float32)
        self._tick = 0
        # one-tick-lagged readback: the tokens just launched and the
        # (slot, req, remaining-after) snapshot they belong to
        self._inflight: Optional[tuple] = None
        self._pending_first: list = []      # [(req, _Readback)]
        self._init_intake(metrics=m)

    # -- request lifecycle ---------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.req is None:
                return i
        return None

    def _splice(self, one_state, slot: int):
        """Copy a one-row prefill state into ``slot`` of the batch state
        (scan-stacked caches are [n_scan, B, ...])."""
        for buf, new in zip(self.state["scan"], one_state["scan"]):
            for name, t in buf.items():
                t[:, slot] = new[name][:, 0]
        self.state["len"][slot] = one_state["len"][0]

    def _admit(self):
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            req = self.queue.popleft()
            batch = self._pad_prompt(req.prompt, self.PREFILL_QUANTUM)
            logits, one_state = self.model.prefill(
                self.params, batch, self.max_len, kv_mode=self.kv_mode)
            temps = torch.full((1,), float(req.temperature),
                               device=self.device)
            tok = self._select_token(logits[:, len(req.prompt) - 1], temps,
                                     req.temperature > 0.0)
            self._splice(one_state, slot)
            self.tokens[slot, 0] = tok[0]
            self._temps[slot] = req.temperature
            # the first token is appended at the next harvest (no wait here)
            self._pending_first.append((req, _Readback(tok)))
            self.slots[slot] = _Slot(req, req.max_new - 1)

    # -- main loop -----------------------------------------------------------

    def step(self) -> bool:
        """One engine tick: admit, decode all slots (sampling on the
        device), then harvest the PREVIOUS tick's tokens while this one
        runs."""
        self._admit()
        active = [(i, s) for i, s in enumerate(self.slots)
                  if s.req is not None]
        if not active:
            prev, self._inflight = self._inflight, None
            return self._harvest(prev)
        self._tick += 1
        temps = to_device(self._temps, self.device)
        logits, _ = self.model.decode_step(self.params, self.state,
                                           self.tokens)
        nxt = self._select_token(logits[:, 0], temps,
                                 bool((self._temps > 0.0).any()))
        self.tokens = nxt[:, None]
        snapshot = []
        for i, s in active:
            s.remaining -= 1                     # host-known: speculative
            snapshot.append((i, s.req, s.remaining))
            if s.remaining <= 0:
                # out of budget: free the slot now (its final token is in
                # flight and lands at the next harvest, keyed by req)
                self.slots[i] = _Slot()
        prev, self._inflight = self._inflight, (_Readback(nxt), snapshot)
        self._harvest(prev)
        return True

    def _harvest(self, prev) -> bool:
        """Land the lagged tokens: append, retire EOS/out-of-budget
        requests."""
        firsts, self._pending_first = self._pending_first, []
        if prev is None and not firsts:
            return False
        for req, rb in firsts:
            req.out.append(int(self._wait(rb)[0]))
        if prev is not None:
            rb, snapshot = prev
            nxt = self._wait(rb)
            for i, req, rem in snapshot:
                if req.done:                    # junk token past EOS
                    continue
                tok = int(nxt[i])
                req.out.append(tok)
                self._c_tokens.inc()
                if rem <= 0 or tok == self.eos_id:
                    req.done = True
                    self.finished.append(req)
                    if self.slots[i].req is req:
                        self.slots[i] = _Slot()
        return True

    def sync(self):
        """Wait until every launched tick and prefill has run."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(s.req for s in self.slots)
               or self._inflight is not None or self._pending_first) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished

    def stats(self) -> dict:
        gv = self.metrics.get_value
        return {"tick": self._tick,
                "queued": len(self.queue),
                "active_slots": sum(1 for sl in self.slots
                                    if sl.req is not None),
                "tokens_generated": gv("engine_tokens_generated_total") or 0,
                "harvest_wait_s": gv("engine_harvest_wait_seconds_total")}
