"""Per-page representation ladder: bf16 HOT and int8 WARM pages on the
device, packed COLD pages in host memory.

Counterpart of ``repro.cache.tiers`` for token pages of per-head attention
KV (page kind ``attn_kv``).  MLA latent pages and state slabs are not
ported yet.

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

COLD pages leave the device: each warm int8 plane is packed on the host
with the best of the registered lossless codecs (per-block BDI or FPC,
tried on the plane and on its delta along the token axis, RAW when
nothing is smaller) into one host buffer per page, page-locked when the
store serves the card.  Demotion reads the warm planes back to the host,
which waits for the device (the reference does the same).  Promotion
uploads the COMPRESSED buffer and decodes it on the device -- the BDI and
FPC CUDA kernels (``repro_torch.kernels.{bdi,fpc}``) write into a staging
buffer, the un-delta is a cumulative sum mod 256 along the token axis --
and the staging buffer is scattered into the warm slot.  Before a decode
can read the page, the staged bytes are copied back to page-locked host
memory and their CRC32 checked against the one recorded at demotion
(:class:`ColdPageCorrupt` on a mismatch).  A synchronous promotion checks
before it touches any bookkeeping; an asynchronous one (the prefetch
path) runs the upload, the decode and the copy-back on a side stream with
an event at the end, and its check and scatter happen at
:meth:`TieredKVStore.commit_promotions` -- the engine's tick-start
barrier -- or at :meth:`TieredKVStore.commit_page` for a page read this
tick.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.assist.bytesops import DEFAULT_BLOCK_BYTES
from repro_torch.assist.page_kinds import page_kind
from repro_torch.assist.registry import REGISTRY
from repro_torch.cache.block_pool import PoolExhausted
from repro_torch.kernels.bdi import ops as bdi_ops
from repro_torch.kernels.fpc import ops as fpc_ops
from repro_torch.obs.metrics import MetricsRegistry, log_buckets
from repro_torch.serving.kv_cache import dequantize, quantize_token

TIER_FREE, TIER_HOT, TIER_WARM, TIER_COLD = -1, 0, 1, 2


class ColdPageCorrupt(Exception):
    """A cold page's decoded planes do not match its recorded checksum.

    A synchronous promotion raises it before any state mutates, with the
    page still intact in the cold tier; an asynchronous one raises it at
    the commit that would land the page, before the warm slot is written.
    """

    def __init__(self, pid: int):
        super().__init__(pid)
        self.pid = pid


def planes_crc(raw_planes) -> int:
    """CRC32 over a page's RAW planes -- per segment, per plane: the
    unpacked int8 payload then its f32 scales.  Scheme-independent, as in
    the reference."""
    crc = 0
    for seg in raw_planes:
        for x8, sc in seg:
            crc = zlib.crc32(np.ascontiguousarray(x8).tobytes(), crc)
            if sc is not None:
                crc = zlib.crc32(np.ascontiguousarray(sc).tobytes(), crc)
    return crc


# cold packing consumes the registry's compress tasks: per-block BDI and
# FPC with RAW fallback
COLD_TASKS = {"bdi": REGISTRY.get("bdi_packed"), "fpc": REGISTRY.get("fpc")}
DELTA_SUFFIX = "+delta"
#: bytes one codec block covers (the staging buffer is padded to blocks)
COLD_BLOCK_BYTES = DEFAULT_BLOCK_BYTES
#: alignment of each array inside a cold page's host buffer
_ALIGN = 16
_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.float32): torch.float32}

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


@dataclasses.dataclass
class ColdPage:
    """Host record of one cold page.

    ``planes``: per segment, a list of per-plane records ``(scheme_name,
    packed_obj, scales)``; ``packed_obj`` is the raw int8 plane for
    ``"raw"``.  Every array of ``planes`` is a view into ``blob``, one host
    buffer (page-locked when the store serves the card) that a promotion
    uploads whole; ``spans[i][k]`` are the byte offsets of plane k's
    arrays in it, scales last.  ``nbytes`` is the packed size the host
    budget charges (codec bytes plus raw scales, as the reference).
    """
    planes: list
    nbytes: int
    blob: torch.Tensor
    spans: list


def delta_seq(x8: np.ndarray, axis: int = -2) -> np.ndarray:
    """Invertible per-page delta along the token (sequence) axis.

    d[0] = x[0]; d[t] = x[t] - x[t-1] (mod 256, int8 two's complement).
    Decode KV is temporally correlated, so the deltas concentrate near
    zero, where BDI's and FPC's narrow encodings pay."""
    x16 = x8.astype(np.int16)
    first = np.take(x16, [0], axis=axis)
    d = np.concatenate([first, np.diff(x16, axis=axis)], axis=axis)
    return d.astype(np.int8)                  # mod-256 wrap


def undelta_seq(d8: np.ndarray, axis: int = -2) -> np.ndarray:
    """Inverse of :func:`delta_seq` (exact under mod-256 arithmetic)."""
    return np.cumsum(d8.astype(np.int64), axis=axis).astype(np.int8)


def undelta_seq_(x8: torch.Tensor) -> torch.Tensor:
    """:func:`undelta_seq` in place on a device tensor (axis -2): a
    cumulative sum in int32, then the low byte."""
    s = torch.cumsum(x8.to(torch.int32), dim=-2)
    return x8.copy_((s & 0xFF).to(torch.uint8).view(torch.int8))


def _pack_cold(x8: np.ndarray, use_delta: bool = True):
    """Pack one int8 plane with the best lossless scheme (RAW fallback).

    Tries BDI/FPC on the plane as-is and, when ``use_delta``, on its
    delta-along-sequence transform; keeps the smallest (the first on a
    tie).  The scheme name records the transform (``"bdi+delta"``) so
    unpacking can invert it.  -> (name, packed object, packed bytes)."""
    planes_to_try = [("", x8)]
    if use_delta:
        planes_to_try.append((DELTA_SUFFIX, delta_seq(x8)))
    best_name, best_obj, best_bytes = "raw", np.asarray(x8), x8.nbytes
    for suffix, plane in planes_to_try:
        for name, task in COLD_TASKS.items():
            c = task.compress(plane)
            if c.compressed_bytes() < best_bytes:
                best_name = name + suffix
                best_obj, best_bytes = c, c.compressed_bytes()
    return best_name, best_obj, best_bytes


def _plane_arrays(name: str, obj) -> tuple:
    """The host arrays of one packed plane, in the order the decoders take
    them: (stream, offsets, encodings) for a codec, (plane,) for raw."""
    if name == "raw":
        return (obj,)
    meta = obj.enc if name.startswith("bdi") else obj.seg_enc
    return (obj.stream, obj.offsets, meta)


def _with_arrays(name: str, obj, views):
    """``obj`` with its arrays replaced by ``views`` (same shapes)."""
    if name == "raw":
        return views[0]
    meta = "enc" if name.startswith("bdi") else "seg_enc"
    return dataclasses.replace(obj, stream=views[0], offsets=views[1],
                               **{meta: views[2]})


def _unpack_cold(name: str, fields, out: torch.Tensor, shape):
    """Decode one cold plane into ``out`` on the device its fields lie on.

    ``fields``: the plane's arrays as device tensors (see
    :func:`_plane_arrays`); ``out``: uint8 staging bytes, the plane's size
    rounded up to whole codec blocks.  RAW is a copy; BDI and FPC run
    their decode wrappers (the CUDA kernels on the card, the plain forms
    on the CPU) straight into ``out``; ``+delta`` planes are then
    un-delta'd in place."""
    n = int(np.prod(shape))
    if name == "raw":
        out[:n].copy_(fields[0].view(torch.uint8).reshape(-1))
        return
    base, delta = name, False
    if name.endswith(DELTA_SUFFIX):
        base, delta = name[:-len(DELTA_SUFFIX)], True
    stream, offsets, meta = fields
    blocks = out.view(-1, COLD_BLOCK_BYTES)
    if base == "bdi":
        bdi_ops.decompress_packed_blocks(stream, offsets, meta,
                                         block_bytes=COLD_BLOCK_BYTES,
                                         out=blocks)
    else:
        fpc_ops.decompress_blocks(stream, offsets, meta, out=blocks)
    if delta:
        undelta_seq_(out[:n].view(torch.int8).view(shape))


def _host_buffer(arrays, pin: bool):
    """Copy ``arrays`` into one host uint8 buffer (page-locked if ``pin``),
    each at a ``_ALIGN``-byte offset -> (buffer, offsets, views)."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    views = []
    for a, o in zip(arrays, offs):
        v = host[o:o + a.nbytes].view(a.dtype).reshape(a.shape)
        v[...] = a
        views.append(v)
    return buf, offs, views


@dataclasses.dataclass
class _Unpacked:
    """A cold page decoded into a device staging buffer, not yet landed:
    the staged bytes, their host copy for the checksum, the event that
    marks both done (None on the CPU), and the buffers the copies read."""
    pid: int
    warm_slot: int
    staged: torch.Tensor
    readback: torch.Tensor
    event: Optional[object]
    crc: Optional[int]
    keep: tuple


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
    """Physical placement of token pages across the hot, warm and cold tiers.

    ``num_pages`` is the logical page-id space (the BlockPool's); the hot
    and warm pools have their own, smaller slot spaces, and cold pages
    live in host memory.  ``tier[pid]`` and ``slot[pid]`` give a page's
    placement; ``encoded_loc`` collapses it to the int32 the decode
    kernels consume.
    """

    def __init__(self, geom: PageGeometry, num_pages: int, *,
                 hot_pages: int, warm_pages: int, device,
                 host_budget_bytes: Optional[int] = None,
                 cold_delta: bool = True, metrics=None):
        if hot_pages < 1:
            raise ValueError("need at least one hot page")
        if geom.has_state:
            raise NotImplementedError("state-slab pages not yet ported")
        self.geom = geom
        self.device = torch.device(device)
        self.num_pages = num_pages
        self.hot_pages = hot_pages
        self.warm_pages = warm_pages
        self.host_budget_bytes = host_budget_bytes
        self.cold_delta = cold_delta

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
        self.cold: dict[int, ColdPage] = {}
        self.cold_bytes = 0
        # CRC32 of each cold page's raw planes, recorded at demotion and
        # checked over the decoded planes at promotion
        self.cold_crc: dict[int, int] = {}
        # asynchronous promotions awaiting the tick-start barrier
        self._pending_warm: dict[int, _Unpacked] = {}
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._stage_spans, self._stage_bytes = self._stage_layout()
        self.mover_batch = MOVER_BATCH
        self._defer_depth = 0
        self._move_run: Optional[str] = None
        self._move_src: list[int] = []
        self._move_dst: list[int] = []
        # pages whose encoded location changed since the engine last asked
        self.dirty_pids: set[int] = set()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_demote = {
            to: m.counter("cache_pages_demoted_total",
                          "pages demoted one tier down", to=to, cls="kv")
            for to in ("warm", "cold")}
        self._c_promote = {
            to: m.counter("cache_pages_promoted_total",
                          "pages promoted one tier up", to=to, cls="kv")
            for to in ("warm", "hot")}
        self._c_promote_async = m.counter(
            "cache_pages_promoted_async_total",
            "async (prefetch-path) cold->warm promotions", cls="kv")
        self._c_released = {
            t: m.counter("cache_pages_released_total",
                         "pages released at retirement, by tier held",
                         tier=t, cls="kv")
            for t in ("hot", "warm", "cold")}
        self._c_disp = {
            k: m.counter("cache_mover_dispatches_total",
                         "batched tier-mover device dispatches", kind=k)
            for k in ("mover", "commit")}
        self._c_moved = {
            k: m.counter("cache_mover_pages_total",
                         "pages carried by batched mover dispatches", kind=k)
            for k in ("mover", "commit")}
        self._h_batch = m.histogram(
            "cache_mover_batch_pages", "pages per mover dispatch "
            "(batch occupancy)", buckets=log_buckets(1.0, 2 * MOVER_BATCH))
        self._c_scheme: dict = {}          # planes packed, by scheme
        self._c_decoded: dict = {}         # planes decoded, by scheme
        self._c_cold_bytes = {
            k: m.counter("cache_cold_bytes_total",
                         "bytes of the pages demoted cold: packed (codec "
                         "bytes + scales) or raw (int8 planes + scales)",
                         form=k)
            for k in ("packed", "raw")}
        self._c_host_s = {
            k: m.counter("cache_cold_host_seconds_total",
                         "host seconds in cold demotions (read-back and "
                         "packing) and promotions (launch and checksum)",
                         op=k)
            for k in ("pack", "promote")}
        self._c_readback = m.counter(
            "cache_cold_checked_bytes_total",
            "staged bytes copied back to the host for the checksum")

    @property
    def stats(self) -> dict:
        """Counter view under the reference's key names."""
        return {"demote_warm": self._c_demote["warm"].value,
                "demote_cold": self._c_demote["cold"].value,
                "promote_warm": self._c_promote["warm"].value,
                "promote_warm_async": self._c_promote_async.value,
                "promote_hot": self._c_promote["hot"].value,
                "mover_dispatches": (self._c_disp["mover"].value
                                     + self._c_disp["commit"].value)}

    def cold_stats(self) -> dict:
        """What the cold tier packed and what it cost the host."""
        demoted = self._c_demote["cold"].value
        promoted = self._c_promote["warm"].value
        pack_s = self._c_host_s["pack"].value
        promote_s = self._c_host_s["promote"].value
        return {"pages": len(self.cold), "bytes": self.cold_bytes,
                "packed_bytes_total": self._c_cold_bytes["packed"].value,
                "raw_bytes_total": self._c_cold_bytes["raw"].value,
                "schemes": {k: c.value for k, c in self._c_scheme.items()},
                "decoded": {k: c.value for k, c in self._c_decoded.items()},
                "pack_ms_per_page": 1e3 * pack_s / max(demoted, 1),
                "promote_ms_per_page": 1e3 * promote_s / max(promoted, 1),
                "checked_bytes": self._c_readback.value}

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
        self._c_disp["mover"].inc()
        self._c_moved["mover"].inc(len(srcs))
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
                "cold": int((self.tier == TIER_COLD).sum())}

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
        self._pending_warm.pop(pid, None)   # in-flight data no longer needed
        self.dirty_pids.add(pid)
        t = self.tier[pid]
        if t == TIER_HOT:
            self._free_hot.append(int(self.slot[pid]))
            self._c_released["hot"].inc()
        elif t == TIER_WARM:
            self._free_warm.append(int(self.slot[pid]))
            self._c_released["warm"].inc()
        elif t == TIER_COLD:
            rec = self.cold.pop(pid)
            self.cold_crc.pop(pid, None)
            self.cold_bytes -= rec.nbytes
            self._c_released["cold"].inc()
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
        self._c_demote["warm"].inc()

    def promote_to_hot(self, pid: int):
        """warm -> hot: dequantize into a hot slot (a page that decode
        writes this tick must be hot)."""
        if self.tier[pid] != TIER_WARM:
            raise ValueError(f"page {pid} is not warm")
        self._commit_one(pid)               # land any in-flight promotion
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
        self._c_promote["hot"].inc()

    def _warm_planes_host(self, ws: int) -> list:
        """Every segment's (int8 plane, f32 scales) pairs of warm slot
        ``ws`` as host arrays, through one device->host copy (which waits
        for the device)."""
        parts = [pools_j[name][:, ws].reshape(-1).view(torch.uint8)
                 for pools_j in self.pools
                 for _, qname, sname in PLANE_TRIPLES
                 for name in (qname, sname)]
        host = torch.cat(parts).cpu().numpy()
        out, at = [], 0
        for pools_j in self.pools:
            seg = []
            for _, qname, sname in PLANE_TRIPLES:
                pair = []
                for name, dt in ((qname, np.int8), (sname, np.float32)):
                    shape = tuple(pools_j[name][:, ws].shape)
                    n = int(np.prod(shape)) * np.dtype(dt).itemsize
                    pair.append(host[at:at + n].view(dt).reshape(shape))
                    at += n
                seg.append(tuple(pair))
            out.append(seg)
        return out

    def demote_to_cold(self, pid: int):
        """warm -> cold: pack the int8 planes (delta + BDI/FPC, RAW
        fallback) into one host buffer."""
        if self.tier[pid] != TIER_WARM:
            raise ValueError(f"page {pid} is not warm")
        t0 = time.perf_counter()
        self._commit_one(pid)               # land any in-flight promotion
        self.flush_movers()                 # packing reads the warm planes
        ws = int(self.slot[pid])
        raw = self._warm_planes_host(ws)
        packed, nbytes = [], 0
        for raw_seg in raw:
            recs = []
            for x8, sc in raw_seg:
                name, obj, nb = _pack_cold(x8, self.cold_delta)
                recs.append((name, obj, sc))
                nbytes += nb + sc.nbytes
            packed.append(recs)
        if (self.host_budget_bytes is not None
                and self.cold_bytes + nbytes > self.host_budget_bytes):
            raise PoolExhausted("cold (host) budget full")
        arrays = [a for recs in packed for name, obj, sc in recs
                  for a in _plane_arrays(name, obj) + (sc,)]
        blob, offs, views = _host_buffer(arrays,
                                         pin=self.device.type == "cuda")
        planes, spans, at = [], [], 0
        for recs in packed:
            seg_planes, seg_spans = [], []
            for name, obj, sc in recs:
                k = len(_plane_arrays(name, obj)) + 1
                v, o = views[at:at + k], offs[at:at + k]
                at += k
                seg_planes.append((name, _with_arrays(name, obj, v[:-1]),
                                   v[-1]))
                seg_spans.append(o)
                self._scheme_counter(self._c_scheme, "packed", name).inc()
            planes.append(seg_planes)
            spans.append(seg_spans)
        self.cold[pid] = ColdPage(planes, nbytes, blob, spans)
        self.cold_crc[pid] = planes_crc(raw)
        self.cold_bytes += nbytes
        self._free_warm.append(ws)
        self.tier[pid], self.slot[pid] = TIER_COLD, 0
        self._warm_ids.discard(pid)
        self.dirty_pids.add(pid)
        self._c_demote["cold"].inc()
        self._c_cold_bytes["packed"].inc(nbytes)
        self._c_cold_bytes["raw"].inc(sum(x8.nbytes + sc.nbytes
                                          for seg in raw for x8, sc in seg))
        self._c_host_s["pack"].inc(time.perf_counter() - t0)

    def _scheme_counter(self, table: dict, op: str, name: str):
        c = table.get(name)
        if c is None:
            c = table[name] = self.metrics.counter(
                "cache_cold_planes_total",
                "cold planes packed at demotion / decoded at promotion, by "
                "scheme", op=op, scheme=name)
        return c

    # -- cold -> warm ---------------------------------------------------------

    def _stage_layout(self):
        """Byte layout of one page's staging buffer: per segment, per
        plane, the int8 plane (padded to whole codec blocks) then its
        scales, each at a 16-byte offset -> (spans, total bytes)."""
        spans, total = [], 0

        def take(n):
            nonlocal total
            at, total = total, total + -(-n // _ALIGN) * _ALIGN
            return at

        for sg in self.geom.segments:
            seg = []
            for w in (sg.k_width, sg.v_width):
                shape = (sg.n_stack, sg.heads, sg.rows, w)
                n = int(np.prod(shape))
                blocks = -(-n // COLD_BLOCK_BYTES) * COLD_BLOCK_BYTES
                x_at = take(blocks)
                sc_shape = shape[:3]
                sc_at = take(4 * int(np.prod(sc_shape)))
                seg.append((x_at, blocks, shape, sc_at, sc_shape))
            spans.append(seg)
        return spans, total

    def _staged_planes(self, buf: torch.Tensor) -> list:
        """Per segment, per plane: (int8 plane, f32 scales) views of a
        staging buffer or of its host copy."""
        out = []
        for seg in self._stage_spans:
            pairs = []
            for x_at, _, shape, sc_at, sc_shape in seg:
                n, m = int(np.prod(shape)), 4 * int(np.prod(sc_shape))
                x = buf[x_at:x_at + n].view(torch.int8).reshape(shape)
                sc = buf[sc_at:sc_at + m].view(torch.float32)
                pairs.append((x, sc.reshape(sc_shape)))
            out.append(pairs)
        return out

    def _unpack(self, pid: int, rec: ColdPage, ws: int, crc,
                side: bool) -> _Unpacked:
        """Upload ``rec``'s host buffer and decode every plane into a fresh
        staging buffer, then copy the staging buffer back to page-locked
        host memory for the checksum.  On the card this runs on the side
        stream when ``side`` (the asynchronous path), else on the current
        stream; an event marks the end."""
        card = self.device.type == "cuda"
        ctx = (torch.cuda.stream(self._side) if side and card
               else contextlib.nullcontext())
        with ctx:
            blob = rec.blob.to(self.device, non_blocking=True) \
                if card else rec.blob
            staged = torch.empty(self._stage_bytes, dtype=torch.uint8,
                                 device=self.device)
            for recs, offs, stg in zip(rec.planes, rec.spans,
                                       self._stage_spans):
                for (name, obj, sc), o, (x_at, blocks, shape, sc_at,
                                         _) in zip(recs, offs, stg):
                    arrays = _plane_arrays(name, obj) + (sc,)
                    fields = [blob[a:a + x.nbytes].view(
                        _TORCH_DTYPE[x.dtype]).view(x.shape)
                        for a, x in zip(o, arrays)]
                    _unpack_cold(name, fields[:-1],
                                 staged[x_at:x_at + blocks], shape)
                    self._scheme_counter(self._c_decoded, "decoded",
                                         name).inc()
                    staged[sc_at:sc_at + sc.nbytes].copy_(
                        blob[o[-1]:o[-1] + sc.nbytes])
            event = None
            if card:
                readback = torch.empty(self._stage_bytes, dtype=torch.uint8,
                                       pin_memory=True)
                readback.copy_(staged, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                readback = staged
        self._c_readback.inc(self._stage_bytes)
        return _Unpacked(pid, ws, staged, readback, event, crc,
                         (blob, rec.blob))

    def _check(self, u: _Unpacked) -> bool:
        """Wait for ``u``'s copy-back and compare the decoded planes' CRC
        with the one recorded at demotion."""
        if u.event is not None:
            u.event.synchronize()
        if u.crc is None:
            return True
        return planes_crc(self._staged_planes(u.readback)) == u.crc

    def _land(self, entries: list):
        """Scatter staged pages into their warm slots, on the current
        stream (ordered after each staging event), one indexed write per
        plane for the whole batch."""
        cur = (torch.cuda.current_stream(self.device)
               if self.device.type == "cuda" else None)
        for u in entries:
            if cur is not None:
                cur.wait_event(u.event)
                u.staged.record_stream(cur)
        ws = to_device(np.array([u.warm_slot for u in entries], np.int64),
                       self.device)
        staged = [self._staged_planes(u.staged) for u in entries]
        for j, pools_j in enumerate(self.pools):
            for k, (_, qname, sname) in enumerate(PLANE_TRIPLES):
                x = torch.stack([p[j][k][0] for p in staged], dim=1)
                sc = torch.stack([p[j][k][1] for p in staged], dim=1)
                pools_j[qname][:, ws] = x
                pools_j[sname][:, ws] = sc

    def promote_to_warm(self, pid: int, *, async_: bool = False):
        """cold -> warm: upload the packed page, decode it on the device
        and write it into a warm slot (bit-exact: the packing is lossless).

        ``async_=True`` (the prefetch path) queues the upload and decode on
        a side stream and defers the checksum and the slot write to
        :meth:`commit_promotions`; otherwise the checksum is checked
        before any bookkeeping changes."""
        if self.tier[pid] != TIER_COLD:
            raise ValueError(f"page {pid} is not cold")
        if not self._free_warm:
            raise PoolExhausted("warm tier full")
        t0 = time.perf_counter()
        rec = self.cold[pid]
        crc = self.cold_crc.get(pid)
        u = self._unpack(pid, rec, 0, crc, side=async_)
        if not async_ and not self._check(u):
            self._c_host_s["promote"].inc(time.perf_counter() - t0)
            raise ColdPageCorrupt(pid)
        self.flush_movers()       # a pending promote may read the slot
        ws = self._free_warm.pop()
        u.warm_slot = ws
        self.cold.pop(pid)
        self.cold_crc.pop(pid, None)
        self.cold_bytes -= rec.nbytes
        if async_:
            self._pending_warm[pid] = u
            self._c_promote_async.inc()
        else:
            self._land([u])
        self.tier[pid], self.slot[pid] = TIER_WARM, ws
        self._warm_ids.add(pid)
        self.dirty_pids.add(pid)
        self._c_promote["warm"].inc()
        self._c_host_s["promote"].inc(time.perf_counter() - t0)

    def promote_many(self, pids) -> list[int]:
        """cold -> warm for a batch of pages: each decodes asynchronously
        and all land through one :meth:`commit_promotions`.  Pages that are
        not cold are skipped; the batch stops early when the warm tier
        runs out.  Returns the pages promoted, already committed."""
        done: list[int] = []
        for pid in pids:
            if self.tier[pid] != TIER_COLD:
                continue
            if not self._free_warm:
                break
            self.promote_to_warm(pid, async_=True)
            done.append(pid)
        if done:
            self.commit_promotions()
        return done

    def commit_page(self, pid: int):
        """Land one page's in-flight promotion now (no-op if none): a page
        about to be read this tick, ahead of the tick-start barrier."""
        self._commit_one(pid)

    def _commit_one(self, pid: int):
        u = self._pending_warm.pop(pid, None)
        if u is not None:
            self._commit([u])

    def commit_promotions(self) -> int:
        """The drain barrier: check and land every in-flight promotion, all
        pages in one batched write per plane.  The engine calls it at tick
        start, before any decode or tier transition can read the warm
        pool."""
        n = len(self._pending_warm)
        if n:
            entries = list(self._pending_warm.values())
            self._pending_warm = {}
            self._commit(entries)
            self._c_disp["commit"].inc()
            self._c_moved["commit"].inc(n)
        return n

    def _commit(self, entries: list):
        """Check every entry's checksum, land the good ones, then raise
        :class:`ColdPageCorrupt` for the first bad one (its warm slot keeps
        whatever it held; its page stays warm in the bookkeeping)."""
        t0 = time.perf_counter()
        good, bad = [], None
        for u in entries:
            if self._check(u):
                good.append(u)
            elif bad is None:
                bad = u
        if good:
            self._land(good)
        self._c_host_s["promote"].inc(time.perf_counter() - t0)
        if bad is not None:
            raise ColdPageCorrupt(bad.pid)
