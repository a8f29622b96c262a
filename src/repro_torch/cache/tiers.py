"""Per-page representation ladder, hot and warm halves: bf16 HOT pages and
int8 WARM pages on the device.

Counterpart of ``repro.cache.tiers`` for token pages of per-head attention
KV (page kind ``attn_kv``).  The packed host cold tier, MLA latent pages
and state slabs are not ported yet.

Physical layout.  The stack is a sequence of pool-owning SEGMENTS (one per
scanned pattern position); each segment's pools are page-indexed on axis 1:

  hot:  kh, vh   bf16[stack, 1+hot,  G, ps, dh]
  warm: k8, v8   int8[stack, 1+warm, G, ps, dh]
        ks, vs    f32[stack, 1+warm, G, ps]       per-token absmax scales

Slot 0 of each pool is a reserved trash page: unmapped block-table entries
read it (the length mask removes them) and writes of idle lanes land on
it.  The *encoded location* of a page is one int32 the decode kernels
consume: ``loc > 0`` hot slot ``loc``, ``loc < 0`` warm slot ``-loc``,
``0`` trash.

Where the reference updates donated pools functionally, this port writes
the pools IN PLACE (indexed assignment on the current stream), which
saves the second copy of every pool a functional update would need.  The
tier movers are batched as in the reference: same-kind transitions that a
policy episode produces (``deferred()``) flush as one dispatch of up to
``MOVER_BATCH`` pages, padded with slot 0 (trash moves to trash).
Bookkeeping is always eager; every pool write flushes pending movers
first, so the deferral is never observable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.assist.page_kinds import page_kind
from repro_torch.cache.block_pool import PoolExhausted
from repro_torch.obs.metrics import MetricsRegistry, log_buckets
from repro_torch.serving.kv_cache import dequantize, quantize_token

TIER_FREE, TIER_HOT, TIER_WARM, TIER_COLD = -1, 0, 1, 2

#: pages one batched mover dispatch moves (padded fixed width)
MOVER_BATCH = 8

#: (hot plane, int8 plane, scale plane) of a token-page pool
PLANE_TRIPLES = (("kh", "k8", "ks"), ("vh", "v8", "vs"))


@dataclasses.dataclass(frozen=True)
class SegmentGeometry:
    """Pool shape of one stack segment: ``n_stack`` layers of ``heads`` KV
    heads, ``rows = page_size`` tokens, k/v widths."""
    kind: str          # page-kind name (repro_torch.assist.page_kinds)
    n_stack: int
    heads: int
    rows: int
    k_width: int
    v_width: int = 0

    @property
    def grows(self) -> bool:
        return page_kind(self.kind).grows

    @property
    def cls(self) -> str:
        return "kv" if self.grows else "state"

    @property
    def hot_itemsize(self) -> int:
        return 4 if self.kind == "state_slab" else 2

    @property
    def n_planes(self) -> int:
        return 2 if self.v_width else 1

    @property
    def hot_bytes(self) -> int:
        per = self.n_stack * self.heads * self.rows
        return per * (self.k_width + self.v_width) * self.hot_itemsize

    @property
    def warm_bytes(self) -> int:
        per = self.n_stack * self.heads * self.rows
        return (per * (self.k_width + self.v_width)      # int8 planes
                + self.n_planes * per * 4)               # f32 scales


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Shape of one page across the stack (the engine derives it from the
    model config via ``models.transformer.paged_geometry``)."""
    n_pat: int
    n_scan: int
    n_kv_heads: int
    page_size: int
    head_dim: int
    segments: tuple

    @property
    def layers_total(self) -> int:
        return sum(sg.n_stack for sg in self.segments)

    @property
    def has_state(self) -> bool:
        return any(sg.cls == "state" for sg in self.segments)

    @property
    def hot_page_bytes(self) -> int:
        """Device bytes of one token page in the hot tier."""
        return sum(sg.hot_bytes for sg in self.segments if sg.cls == "kv")

    @property
    def warm_page_bytes(self) -> int:
        """Device bytes of one token page in the warm tier (int8 + scales)."""
        return sum(sg.warm_bytes for sg in self.segments if sg.cls == "kv")


# -- in-place page movement (up to MOVER_BATCH pages per call) ---------------

def scatter_prefill(pools_j, k_seq, v_seq, locs):
    """Write a prefilled request's KV into its hot pages, in place.

    k_seq/v_seq: [stack, G, S, width] with S == len(locs) * page_size;
    locs: int64[n_pages] hot slots (0 = trash for pages not kept).
    """
    ps = pools_j["kh"].shape[3]

    def per_page(x):            # -> [stack, npg, G, ps, width]
        st, G, S, w = x.shape
        return x.reshape(st, G, S // ps, ps, w).transpose(1, 2)

    pools_j["kh"][:, locs] = per_page(k_seq).to(pools_j["kh"].dtype)
    pools_j["vh"][:, locs] = per_page(v_seq).to(pools_j["vh"].dtype)


def demote_hot_to_warm(pools_j, hot_slots, warm_slots):
    """Quantize hot pages ``hot_slots`` into warm slots ``warm_slots``, in
    place.  Padding entries are 0 (trash quantized into trash)."""
    for hname, qname, sname in PLANE_TRIPLES:
        q, s = quantize_token(pools_j[hname][:, hot_slots])
        pools_j[qname][:, warm_slots] = q
        pools_j[sname][:, warm_slots] = s


def promote_warm_to_hot(pools_j, warm_slots, hot_slots):
    """Dequantize warm pages into hot slots, in place (the quantization
    loss is already paid)."""
    for hname, qname, sname in PLANE_TRIPLES:
        x = dequantize(pools_j[qname][:, warm_slots],
                       pools_j[sname][:, warm_slots])
        pools_j[hname][:, hot_slots] = x.to(pools_j[hname].dtype)


_MOVERS = {"demote": demote_hot_to_warm, "promote": promote_warm_to_hot}


class TieredKVStore:
    """Physical placement of token pages across the hot and warm tiers.

    ``num_pages`` is the logical page-id space (the BlockPool's); the hot
    and warm pools have their own, smaller slot spaces.  ``tier[pid]`` and
    ``slot[pid]`` give a page's placement; ``encoded_loc`` collapses it to
    the int32 the decode kernels consume.
    """

    def __init__(self, geom: PageGeometry, num_pages: int, *,
                 hot_pages: int, warm_pages: int, device, metrics=None):
        if hot_pages < 1:
            raise ValueError("need at least one hot page")
        if geom.has_state:
            raise NotImplementedError("state-slab pages not yet ported")
        self.geom = geom
        self.device = torch.device(device)
        self.num_pages = num_pages
        self.hot_pages = hot_pages
        self.warm_pages = warm_pages

        def mk_pool(sg: SegmentGeometry):
            nh, nw = 1 + hot_pages, 1 + max(warm_pages, 1)
            kw = dict(device=self.device)
            return {
                "kh": torch.zeros((sg.n_stack, nh, sg.heads, sg.rows,
                                   sg.k_width), dtype=torch.bfloat16, **kw),
                "vh": torch.zeros((sg.n_stack, nh, sg.heads, sg.rows,
                                   sg.v_width), dtype=torch.bfloat16, **kw),
                "k8": torch.zeros((sg.n_stack, nw, sg.heads, sg.rows,
                                   sg.k_width), dtype=torch.int8, **kw),
                "v8": torch.zeros((sg.n_stack, nw, sg.heads, sg.rows,
                                   sg.v_width), dtype=torch.int8, **kw),
                "ks": torch.ones((sg.n_stack, nw, sg.heads, sg.rows), **kw),
                "vs": torch.ones((sg.n_stack, nw, sg.heads, sg.rows), **kw),
            }

        # one pool set per segment, in stack order; slot 0 reserved (trash)
        self.pools = tuple(mk_pool(sg) for sg in geom.segments)
        self.tier = np.full(num_pages, TIER_FREE, np.int8)
        self.slot = np.zeros(num_pages, np.int32)
        self._free_hot = list(range(hot_pages, 0, -1))     # pops 1, 2, ...
        self._free_warm = list(range(warm_pages, 0, -1))
        self._hot_ids: set[int] = set()
        self._warm_ids: set[int] = set()
        self.mover_batch = MOVER_BATCH
        self._defer_depth = 0
        self._move_run: Optional[str] = None
        self._move_src: list[int] = []
        self._move_dst: list[int] = []
        # pages whose encoded location changed since the engine last asked
        self.dirty_pids: set[int] = set()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_demote = m.counter("cache_pages_demoted_total",
                                   "pages demoted one tier down",
                                   to="warm", cls="kv")
        self._c_promote = m.counter("cache_pages_promoted_total",
                                    "pages promoted one tier up",
                                    to="hot", cls="kv")
        self._c_released = {
            t: m.counter("cache_pages_released_total",
                         "pages released at retirement, by tier held",
                         tier=t, cls="kv")
            for t in ("hot", "warm")}
        self._c_disp = m.counter("cache_mover_dispatches_total",
                                 "batched tier-mover device dispatches",
                                 kind="mover")
        self._c_moved = m.counter("cache_mover_pages_total",
                                  "pages carried by batched mover "
                                  "dispatches", kind="mover")
        self._h_batch = m.histogram(
            "cache_mover_batch_pages", "pages per mover dispatch "
            "(batch occupancy)", buckets=log_buckets(1.0, 2 * MOVER_BATCH))

    @property
    def stats(self) -> dict:
        """Counter view under the reference's key names (tiers this port
        does not have read 0)."""
        return {"demote_warm": self._c_demote.value,
                "demote_cold": 0,
                "promote_warm": 0,
                "promote_hot": self._c_promote.value,
                "mover_dispatches": self._c_disp.value}

    # -- batched movers ------------------------------------------------------

    def deferred(self):
        """Context manager: accumulate tier-transition copies and flush them
        as batched dispatches at the outermost exit."""
        store = self

        class _Defer:
            def __enter__(self):
                store._defer_depth += 1

            def __exit__(self, *exc):
                store._defer_depth -= 1
                if store._defer_depth == 0:
                    store.flush_movers()

        return _Defer()

    def _enqueue_move(self, op: str, src: int, dst: int):
        if self._defer_depth == 0:
            self._dispatch_moves(op, [src], [dst])
            return
        if self._move_run != op:
            self.flush_movers()                 # kind change: keep order
            self._move_run = op
        self._move_src.append(src)
        self._move_dst.append(dst)
        if len(self._move_src) >= self.mover_batch:
            self.flush_movers()

    def flush_movers(self):
        """Land every accumulated tier-transition copy now."""
        if not self._move_src:
            self._move_run = None
            return
        op, srcs, dsts = self._move_run, self._move_src, self._move_dst
        self._move_run, self._move_src, self._move_dst = None, [], []
        self._dispatch_moves(op, srcs, dsts)

    def _dispatch_moves(self, op: str, srcs, dsts):
        """One batched mover per segment, slot vectors padded to
        ``mover_batch`` with 0."""
        K = max(self.mover_batch, len(srcs))
        src = np.zeros(K, np.int64)
        dst = np.zeros(K, np.int64)
        src[:len(srcs)] = srcs
        dst[:len(dsts)] = dsts
        src_t, dst_t = to_device(src, self.device), to_device(dst, self.device)
        for pools_j in self.pools:
            _MOVERS[op](pools_j, src_t, dst_t)
        self._c_disp.inc()
        self._c_moved.inc(len(srcs))
        self._h_batch.observe(len(srcs))

    # -- placement queries ---------------------------------------------------

    def drain_dirty(self) -> set[int]:
        """Pages whose encoded location changed since the last drain."""
        d, self.dirty_pids = self.dirty_pids, set()
        return d

    @property
    def n_free_hot(self) -> int:
        return len(self._free_hot)

    @property
    def n_free_warm(self) -> int:
        return len(self._free_warm)

    def hot_page_ids(self):
        return self._hot_ids

    def warm_page_ids(self):
        return self._warm_ids

    def encoded_loc(self, pid: int) -> int:
        t = self.tier[pid]
        if t == TIER_HOT:
            return int(self.slot[pid])
        if t == TIER_WARM:
            return -int(self.slot[pid])
        raise ValueError(f"page {pid} not gatherable (tier {t})")

    def hbm_bytes_used(self) -> int:
        g = self.geom
        return (len(self._hot_ids) * g.hot_page_bytes
                + len(self._warm_ids) * g.warm_page_bytes)

    def tier_counts(self) -> dict[str, int]:
        return {"hot": int((self.tier == TIER_HOT).sum()),
                "warm": int((self.tier == TIER_WARM).sum()),
                "cold": 0}

    # -- placement lifecycle -------------------------------------------------

    def place_hot(self, pid: int) -> int:
        """Bind a fresh page id to a hot slot."""
        if self.tier[pid] != TIER_FREE:
            raise ValueError(f"page {pid} already placed")
        if not self._free_hot:
            raise PoolExhausted("hot tier full")
        s = self._free_hot.pop()
        self.tier[pid], self.slot[pid] = TIER_HOT, s
        self._hot_ids.add(pid)
        self.dirty_pids.add(pid)
        return s

    def release(self, pid: int):
        """Free a page's physical residence (request retired)."""
        self.dirty_pids.add(pid)
        t = self.tier[pid]
        if t == TIER_HOT:
            self._free_hot.append(int(self.slot[pid]))
            self._c_released["hot"].inc()
        elif t == TIER_WARM:
            self._free_warm.append(int(self.slot[pid]))
            self._c_released["warm"].inc()
        self._hot_ids.discard(pid)
        self._warm_ids.discard(pid)
        self.tier[pid], self.slot[pid] = TIER_FREE, 0

    def write_prefill(self, pid_slots: list[int], state_kv: list, S: int):
        """Scatter a prefilled request's per-layer KV into its hot pages.

        pid_slots: hot slots of the request's pages (already placed);
        state_kv: per segment (k_seq, v_seq) bf16[stack, G, S_pad, dh].
        """
        self.flush_movers()       # a pending demote may read these slots
        ps = self.geom.page_size
        if len(pid_slots) < -(-S // ps):
            raise ValueError(f"{len(pid_slots)} pages cannot hold {S} tokens")
        for pools_j, (k_seq, v_seq) in zip(self.pools, state_kv):
            locs = np.zeros(k_seq.shape[2] // ps, np.int64)
            locs[:len(pid_slots)] = pid_slots
            scatter_prefill(pools_j, k_seq, v_seq,
                            to_device(locs, self.device))

    # -- tier transitions ----------------------------------------------------

    def demote_to_warm(self, pid: int):
        """hot -> warm: per-token absmax int8 (the CABA KV site)."""
        if self.tier[pid] != TIER_HOT:
            raise ValueError(f"page {pid} is not hot")
        if not self._free_warm:
            raise PoolExhausted("warm tier full")
        hs = int(self.slot[pid])
        ws = self._free_warm.pop()
        self._enqueue_move("demote", hs, ws)
        self._free_hot.append(hs)
        self.tier[pid], self.slot[pid] = TIER_WARM, ws
        self._hot_ids.discard(pid)
        self._warm_ids.add(pid)
        self.dirty_pids.add(pid)
        self._c_demote.inc()

    def promote_to_hot(self, pid: int):
        """warm -> hot: dequantize into a hot slot (a page that decode
        writes this tick must be hot)."""
        if self.tier[pid] != TIER_WARM:
            raise ValueError(f"page {pid} is not warm")
        if not self._free_hot:
            raise PoolExhausted("hot tier full")
        ws = int(self.slot[pid])
        hs = self._free_hot.pop()
        self._enqueue_move("promote", ws, hs)
        self._free_warm.append(ws)
        self.tier[pid], self.slot[pid] = TIER_HOT, hs
        self._warm_ids.discard(pid)
        self._hot_ids.add(pid)
        self.dirty_pids.add(pid)
        self._c_promote.inc()
