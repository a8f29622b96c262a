"""Base-Delta-Immediate compression, variable rate (paper 5.1.1-5.1.3).

Counterpart of the per-block half of ``repro.assist.schemes.bdi``: a
block ("cache line", 512 B) is read as 2/4/8-byte words and coded as
zeros, one repeated 8-byte value, base + narrow deltas (with a per-word
mask choosing the block's first word or zero as the base), or raw; each
block takes the smallest encoding that fits it.  Records
``[enc | base | mask | deltas]`` are packed into one byte stream with a
per-block offset table.

The encoder runs on the host in numpy, vectorized over blocks, and gives
the reference's bytes exactly: stream, offsets, encodings, the 4-byte
record alignment and the ``1 + block_bytes`` over-fetch padding.  The
plain decoder is PyTorch (:func:`decode_packed_blocks`): the oracle of the
CUDA kernel in ``repro_torch.kernels.bdi`` and the form it takes for CPU
tensors.  The uniform (one encoding per tensor) codec is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.assist import bytesops as bo

# encoding table: id -> (name, word_bytes, delta_bytes)
# word_bytes == 0 encodes the specials (zeros / raw).
ENCODINGS: tuple[tuple[int, str, int, int], ...] = (
    (0, "zeros", 0, 0),
    (1, "rep8", 8, 0),
    (2, "b8d1", 8, 1),
    (3, "b8d2", 8, 2),
    (4, "b8d4", 8, 4),
    (5, "b4d1", 4, 1),
    (6, "b4d2", 4, 2),
    (7, "b2d1", 2, 1),
    (8, "raw", 0, 0),
)
ENC_BY_NAME = {name: (i, wb, db) for i, name, wb, db in ENCODINGS}
RAW_ID = 8
ZEROS_ID = 0
REP8_ID = 1


def enc_size(enc_id: int, block_bytes: int) -> int:
    """Compressed bytes for one block under an encoding (incl. 1 B id)."""
    _, name, wb, db = ENCODINGS[enc_id]
    if name == "zeros":
        return 1
    if name == "rep8":
        return 1 + 8
    if name == "raw":
        return 1 + block_bytes
    W = block_bytes // wb
    return 1 + wb + -(-W // 8) + W * db


def _in_range(d: np.ndarray, delta_bytes: int) -> np.ndarray:
    lim = 1 << (8 * delta_bytes - 1)
    return (d >= -lim) & (d < lim)


def analyze(blocks: np.ndarray) -> np.ndarray:
    """bool[nblocks, n_encodings]: does encoding e fit block i losslessly?

    As the reference: a word fits if its delta from the block's first word
    or its value itself (zero base) fits the delta width as a signed
    number; deltas wrap at 64 bits for 8-byte words and at 32 bits for the
    narrower ones."""
    nblocks = blocks.shape[0]
    feas = np.zeros((nblocks, len(ENCODINGS)), bool)
    feas[:, ZEROS_ID] = np.all(blocks == 0, axis=-1)
    w = bo.words_of(blocks, 8)
    d = w - w[:, :1]                              # int64 wrap, as uint64
    feas[:, REP8_ID] = np.all(d == 0, axis=-1)
    for name in ("b8d1", "b8d2", "b8d4"):
        eid, _, db = ENC_BY_NAME[name]
        feas[:, eid] = np.all(_in_range(d, db) | _in_range(w, db), axis=-1)
    for wb, names in ((4, ("b4d1", "b4d2")), (2, ("b2d1",))):
        w = bo.words_of(blocks, wb)
        d = bo.sext((w - w[:, :1]) & 0xFFFFFFFF, 32)
        z = bo.sext(w, 32)
        for name in names:
            eid, _, db = ENC_BY_NAME[name]
            feas[:, eid] = np.all(_in_range(d, db) | _in_range(z, db),
                                  axis=-1)
    feas[:, RAW_ID] = True
    return feas


def best_encoding_per_block(blocks: np.ndarray,
                            allowed: tuple[int, ...] | None = None
                            ) -> np.ndarray:
    """int32[nblocks]: the smallest feasible encoding per block (paper
    Alg. 2), the lowest id on a tie.  ``allowed`` restricts the set; RAW
    is always allowed."""
    B = blocks.shape[-1]
    sizes = np.array([enc_size(i, B) for i, *_ in ENCODINGS], np.int64)
    cost = np.where(analyze(blocks), sizes, 1 << 30)
    if allowed is not None:
        allow = np.zeros(len(ENCODINGS), bool)
        allow[list(allowed) + [RAW_ID]] = True
        cost = np.where(allow, cost, 1 << 30)
    return np.argmin(cost, axis=-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BDIPacked:
    """Variable-rate BDI: records ``[enc | base | mask | deltas]`` at
    ``offsets`` in one byte stream (host arrays)."""
    stream: np.ndarray    # uint8[stream_bytes + 1 + block_bytes]
    offsets: np.ndarray   # int32[nblocks]  byte offset of each record
    enc: np.ndarray       # uint8[nblocks]
    shape: tuple
    dtype_name: str
    block_bytes: int
    pad: int
    stream_bytes: int     # true (unpadded) stream length

    @property
    def nblocks(self) -> int:
        return self.enc.shape[0]

    def compressed_bytes(self) -> int:
        return self.stream_bytes + self.offsets.size * 4 + self.enc.size


def _encode_blocks_np(blocks: np.ndarray, enc_id: int) -> np.ndarray:
    """Records of ``blocks`` (uint8[n, B]) under one encoding ->
    uint8[n, enc_size]: the reference's ``_encode_one_block_np`` for many
    blocks at once."""
    n, B = blocks.shape
    _, name, wb, db = ENCODINGS[enc_id]
    head = np.full((n, 1), enc_id, np.uint8)
    if name == "zeros":
        return head
    if name == "rep8":
        return np.concatenate([head, blocks[:, :8]], axis=1)
    if name == "raw":
        return np.concatenate([head, blocks], axis=1)
    asint = bo.words_of(blocks, wb)
    base = asint[:, :1]
    delta = asint - base               # not wrapped below 64 bits, as the
    use_base = _in_range(delta, db)    # reference's int64 encoder
    sel = np.where(use_base, delta, asint)
    mask = np.packbits(use_base, axis=-1, bitorder="little")
    return np.concatenate([head, bo.low_bytes(base, wb), mask,
                           bo.low_bytes(sel, db)], axis=1)


def compress_packed(x: np.ndarray,
                    block_bytes: int = bo.DEFAULT_BLOCK_BYTES,
                    align: int = 4,
                    allowed: tuple[int, ...] | None = None) -> BDIPacked:
    """Per-block best-encoding compression into a packed stream (host)."""
    x = np.asarray(x)
    blocks, pad = bo.pad_to_blocks(bo.to_bytes(x), block_bytes)
    enc = best_encoding_per_block(blocks, allowed)
    rec_len = np.array([enc_size(i, block_bytes) for i, *_ in ENCODINGS],
                       np.int64)
    sizes = -(-rec_len[enc] // align) * align
    offsets = np.zeros(len(enc), np.int64)
    offsets[1:] = np.cumsum(sizes)[:-1]
    total = int(offsets[-1] + sizes[-1]) if len(enc) else 0
    # pad so a record slice of the largest size stays in bounds
    stream = np.zeros(total + 1 + block_bytes, np.uint8)
    for eid in np.unique(enc):
        rows = np.nonzero(enc == eid)[0]
        recs = _encode_blocks_np(blocks[rows], int(eid))
        stream[offsets[rows][:, None] + np.arange(recs.shape[1])] = recs
    return BDIPacked(stream=stream, offsets=offsets.astype(np.int32),
                     enc=enc.astype(np.uint8), shape=tuple(x.shape),
                     dtype_name=str(x.dtype), block_bytes=block_bytes,
                     pad=pad, stream_bytes=total)


def _le(b: torch.Tensor, n: int) -> torch.Tensor:
    """int64[..., n] little-endian bytes -> int64[...] value."""
    v = b[..., 0]
    for k in range(1, n):
        v = v | (b[..., k] << (8 * k))
    return v


def _bytes_of(v: torch.Tensor, n: int) -> torch.Tensor:
    """int64[n_rows, W] -> the low ``n`` bytes of each word, little-endian,
    as int64[n_rows, W * n]."""
    parts = [(v >> (8 * k)) & 0xFF for k in range(n)]
    return torch.stack(parts, dim=-1).reshape(v.shape[0], -1)


def _decode_bd(rec: torch.Tensor, wb: int, db: int, B: int) -> torch.Tensor:
    """Base + delta records (int64[n, >= enc_size]) -> int64 bytes [n, B].
    Sums are kept in 32-bit halves, so nothing overflows int64."""
    n = rec.shape[0]
    W = B // wb
    mb = -(-W // 8)
    bits = (rec[:, 1 + wb:1 + wb + mb, None]
            >> torch.arange(8, device=rec.device)) & 1
    use_base = bits.reshape(n, mb * 8)[:, :W] == 1
    d = bo.sext(_le(rec[:, 1 + wb + mb:1 + wb + mb + W * db]
                    .reshape(n, W, db), db), 8 * db)
    if wb == 8:
        lo, hi = d & 0xFFFFFFFF, (d >> 32) & 0xFFFFFFFF
        b_lo = _le(rec[:, 1:5], 4)[:, None]
        b_hi = _le(rec[:, 5:9], 4)[:, None]
        s_lo = b_lo + lo
        s_hi = (b_hi + hi + (s_lo >> 32)) & 0xFFFFFFFF
        lo = torch.where(use_base, s_lo & 0xFFFFFFFF, lo)
        hi = torch.where(use_base, s_hi, hi)
        return torch.stack([_bytes_of(lo, 4).reshape(n, W, 4),
                            _bytes_of(hi, 4).reshape(n, W, 4)],
                           dim=2).reshape(n, B)
    base = _le(rec[:, 1:1 + wb], wb)[:, None]
    v = torch.where(use_base, base + d, d) & ((1 << (8 * wb)) - 1)
    return _bytes_of(v, wb)


def decode_packed_blocks(stream: torch.Tensor, offsets: torch.Tensor,
                         enc: torch.Tensor,
                         block_bytes: int = bo.DEFAULT_BLOCK_BYTES
                         ) -> torch.Tensor:
    """Plain PyTorch decode of a packed BDI stream on any device.

    stream uint8[S]; offsets int32[nb]; enc uint8[nb] -> uint8[nb, B].
    Each block's record is fetched at its offset (``1 + B`` bytes, which
    the stream's padding keeps in bounds) and decoded by its encoding id;
    an id outside the table decodes to zeros."""
    B = block_bytes
    nb = offsets.shape[0]
    idx = offsets.long()[:, None] + torch.arange(1 + B, device=stream.device)
    rec = stream[idx].long()
    out = torch.zeros((nb, B), dtype=torch.int64, device=stream.device)
    e = enc.long()
    for eid, name, wb, db in ENCODINGS:
        rows = torch.nonzero(e == eid).flatten()
        if name == "zeros" or rows.numel() == 0:
            continue
        r = rec[rows]
        if name == "rep8":
            out[rows] = r[:, 1:9].repeat(1, B // 8)
        elif name == "raw":
            out[rows] = r[:, 1:1 + B]
        else:
            out[rows] = _decode_bd(r, wb, db, B)
    return out.to(torch.uint8)


def decompress_packed(c: BDIPacked) -> np.ndarray:
    """Host decode of a :class:`BDIPacked` -> the original array (bf16
    comes back as its uint16 bit patterns)."""
    blocks = decode_packed_blocks(torch.tensor(c.stream),
                                  torch.tensor(c.offsets),
                                  torch.tensor(c.enc), c.block_bytes)
    return from_bytes(blocks.numpy().reshape(-1), c.dtype_name, c.shape)


def from_bytes(flat_u8: np.ndarray, dtype_name: str, shape) -> np.ndarray:
    """The first ``prod(shape)`` items of decoded bytes as ``dtype_name``
    (``bfloat16`` as uint16 bit patterns: numpy has no bf16)."""
    dtype = np.dtype(np.uint16 if dtype_name == "bfloat16" else dtype_name)
    n = int(np.prod(shape)) * dtype.itemsize
    return flat_u8[:n].view(dtype).reshape(shape)
