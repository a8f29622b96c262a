"""Base-Delta-Immediate compression (paper 5.1.1-5.1.3).

Counterpart of ``repro.assist.schemes.bdi``: a block ("cache line", 512 B)
is read as 2/4/8-byte words and coded as zeros, one repeated 8-byte
value, base + narrow deltas (with a per-word mask choosing the block's
first word or zero as the base), or raw.  Two modes, as the reference:

* UNIFORM (:func:`compress_uniform`): one encoding for the whole tensor,
  the smallest that fits every block, in a fixed SoA layout.  It runs as
  PyTorch ops on the tensor's device and gives the reference's bytes; on
  CUDA tensors the b2d1/b4d1/b4d2 encodings go through the BDI encode and
  decode kernels of ``repro_torch.kernels.bdi``.
* PACKED (:func:`compress_packed`): each block takes its own smallest
  encoding, and records ``[enc | base | mask | deltas]`` are packed into
  one byte stream with a per-block offset table.  The encoder runs on
  the host in numpy, vectorized over blocks, and gives the reference's
  bytes exactly: stream, offsets, encodings, the 4-byte record alignment
  and the ``1 + block_bytes`` over-fetch padding.  The plain decoder is
  PyTorch (:func:`decode_packed_blocks`): the oracle of the packed decode
  kernel and the form it takes for CPU tensors.
"""
from __future__ import annotations

import dataclasses
import math

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
# the fixed encodings the uniform kernels take: name -> (word_bytes,
# delta_bytes)
UNIFORM_KERNEL_PARAMS = {n: ENC_BY_NAME[n][1:]
                         for n in ("b2d1", "b4d1", "b4d2")}


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


def analyze(blocks: torch.Tensor) -> torch.Tensor:
    """bool[nblocks, n_encodings]: does encoding e fit block i losslessly?

    As the reference: a word fits if its delta from the block's first word
    or its value itself (zero base) fits the delta width as a signed
    number; deltas wrap at 64 bits for 8-byte words and at 32 bits for the
    narrower ones.  Runs on the blocks' device."""
    nblocks = blocks.shape[0]
    feas = torch.zeros((nblocks, len(ENCODINGS)), dtype=torch.bool,
                       device=blocks.device)
    feas[:, ZEROS_ID] = (blocks == 0).all(dim=-1)
    w = bo.words_from_block(blocks, 8)
    d = w - w[:, :1]
    feas[:, REP8_ID] = (d == 0).all(dim=-1)
    for name in ("b8d1", "b8d2", "b8d4"):
        eid, _, db = ENC_BY_NAME[name]
        feas[:, eid] = (bo.fits_signed64(d, db)
                        | bo.fits_signed64(w, db)).all(dim=-1)
    for wb, names in ((4, ("b4d1", "b4d2")), (2, ("b2d1",))):
        w = bo.words_from_block(blocks, wb)
        d = (w - w[:, :1]) & 0xFFFFFFFF
        for name in names:
            eid, _, db = ENC_BY_NAME[name]
            feas[:, eid] = (bo.fits_signed32(d, db)
                            | bo.fits_signed32(w, db)).all(dim=-1)
    feas[:, RAW_ID] = True
    return feas


def best_encoding_per_block(blocks: np.ndarray,
                            allowed: tuple[int, ...] | None = None
                            ) -> np.ndarray:
    """int32[nblocks]: the smallest feasible encoding per block of host
    blocks (paper Alg. 2), the lowest id on a tie.  ``allowed`` restricts
    the set; RAW is always allowed."""
    B = blocks.shape[-1]
    sizes = np.array([enc_size(i, B) for i, *_ in ENCODINGS], np.int64)
    feas = analyze(torch.from_numpy(np.array(blocks))).numpy()
    cost = np.where(feas, sizes, 1 << 30)
    if allowed is not None:
        allow = np.zeros(len(ENCODINGS), bool)
        allow[list(allowed) + [RAW_ID]] = True
        cost = np.where(allow, cost, 1 << 30)
    return np.argmin(cost, axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# UNIFORM mode: one encoding per tensor (PyTorch, on the tensor's device)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BDIUniform:
    """BDI-compressed tensor, one encoding for every block (SoA layout).

    ``base`` is each block's first word (its 8-byte value for rep8 and the
    b8 encodings, zero-extended otherwise; 0 for zeros and raw), where the
    reference keeps (lo, hi) uint32 halves.  Raw blocks sit in ``deltas``.
    """
    base: torch.Tensor     # int64[nblocks]
    mask: torch.Tensor     # uint8[nblocks, ceil(W/8)]  base-vs-zero selector
    deltas: torch.Tensor   # uint8[nblocks, W * delta_bytes]
    enc_id: int
    shape: tuple
    dtype_name: str
    block_bytes: int
    pad: int

    @property
    def nblocks(self) -> int:
        return self.base.shape[0]

    def compressed_bytes(self) -> int:
        wb = ENCODINGS[self.enc_id][2]
        return (self.nblocks * (1 + wb) + self.mask.numel()
                + self.deltas.numel())

    def original_bytes(self) -> int:
        return original_bytes(self.shape, self.dtype_name)

    def ratio(self) -> float:
        return self.original_bytes() / max(self.compressed_bytes(), 1)


def encode_bd(blocks: torch.Tensor, wb: int, db: int):
    """Base + delta encode (paper Alg. 2) of uint8[nb, B] blocks under one
    encoding -> (base int64[nb], mask, deltas, ok bool[nb]).  A word takes
    the block's first word as its base where its delta fits, else the zero
    base; ``ok`` says every word of the block fit one of the two."""
    fits = bo.fits_signed64 if wb == 8 else bo.fits_signed32
    w = bo.words_from_block(blocks, wb)
    base = w[:, :1]
    d = w - base if wb == 8 else (w - base) & 0xFFFFFFFF
    from_base = fits(d, db)
    ok = (from_base | fits(w, db)).all(dim=-1)
    sel = torch.where(from_base, d, w)
    return (base[:, 0], bo.pack_bits(from_base), bo.pack_low_bytes(sel, db),
            ok)


def _encode_uniform(blocks: torch.Tensor, enc_id: int):
    """(base, mask, deltas) of every block under one encoding, in plain
    PyTorch.  The caller guarantees feasibility."""
    nblocks = blocks.shape[0]
    _, name, wb, db = ENCODINGS[enc_id]
    empty = blocks.new_zeros((nblocks, 0))
    zero = torch.zeros(nblocks, dtype=torch.int64, device=blocks.device)
    if name == "zeros":
        return zero, empty, empty
    if name == "rep8":
        return bo.words_from_block(blocks, 8)[:, 0], empty, empty
    if name == "raw":
        return zero, empty, blocks.clone()
    return encode_bd(blocks, wb, db)[:3]


def _uniform_encoding(blocks: torch.Tensor) -> int:
    feas_all = analyze(blocks).all(dim=0).cpu().numpy()
    B = blocks.shape[-1]
    sizes = np.array([enc_size(i, B) for i, *_ in ENCODINGS], np.int64)
    return int(np.argmin(np.where(feas_all, sizes, 1 << 30)))


def choose_uniform_encoding(x: torch.Tensor,
                            block_bytes: int = bo.DEFAULT_BLOCK_BYTES) -> int:
    """Smallest encoding feasible for EVERY block (the paper's
    one-encoding optimization), the lowest id on a tie."""
    return _uniform_encoding(bo.pad_to_blocks(bo.to_bytes(x),
                                              block_bytes)[0])


def compress_uniform(x: torch.Tensor, enc_id: int | None = None,
                     block_bytes: int = bo.DEFAULT_BLOCK_BYTES) -> BDIUniform:
    """Compress tensor ``x`` with one tensor-wide encoding (lossless), on
    its device.  ``enc_id=None`` picks the best feasible one.  A CUDA
    tensor under b2d1, b4d1 or b4d2 is encoded by the BDI encode kernel;
    every other case runs as plain PyTorch ops."""
    blocks, pad = bo.pad_to_blocks(bo.to_bytes(x), block_bytes)
    if enc_id is None:
        enc_id = _uniform_encoding(blocks)
    _, name, wb, _ = ENCODINGS[enc_id]
    if blocks.is_cuda and name in UNIFORM_KERNEL_PARAMS:
        from repro_torch.kernels.bdi import ops as bdi_ops
        words = blocks.view(bo.word_dtype(wb))
        base, mask, deltas, _ = bdi_ops.compress(words, enc=name)
        base = base[:, 0].long() & 0xFFFFFFFF
    else:
        base, mask, deltas = _encode_uniform(blocks, enc_id)
    return BDIUniform(base=base, mask=mask, deltas=deltas, enc_id=enc_id,
                      shape=tuple(x.shape), dtype_name=dtype_name(x.dtype),
                      block_bytes=block_bytes, pad=pad)


def decode_bd(base: torch.Tensor, mask: torch.Tensor, deltas: torch.Tensor,
              wb: int, db: int, block_bytes: int) -> torch.Tensor:
    """Base + delta decode (paper Alg. 1) of ``nb`` blocks -> uint8[nb, B]:
    each delta sign-extended, plus the block's base (int64[nb]) where its
    mask bit is set, truncated to the word width (64-bit words wrap)."""
    W = block_bytes // wb
    use_base = bo.unpack_bits(mask, W)
    d = bo.sext(bo.unpack_low_bytes(deltas, W, db), 8 * db)
    v = torch.where(use_base, d + base[:, None], d)
    return bo.block_from_words(v, wb, block_bytes)


def _decode_uniform_blocks(c: BDIUniform) -> torch.Tensor:
    """uint8[nblocks, block_bytes] of reconstructed data, plain PyTorch."""
    B = c.block_bytes
    _, name, wb, db = ENCODINGS[c.enc_id]
    if name == "zeros":
        return torch.zeros((c.nblocks, B), dtype=torch.uint8,
                           device=c.base.device)
    if name == "rep8":
        return bo.block_from_words(c.base[:, None].expand(-1, B // 8), 8, B)
    if name == "raw":
        return c.deltas
    return decode_bd(c.base, c.mask, c.deltas, wb, db, B)


def decompress_uniform(c: BDIUniform) -> torch.Tensor:
    """The original tensor, on the codec's device.  CUDA tensors under
    b2d1, b4d1 or b4d2 are decoded by the BDI decode kernel."""
    name = ENCODINGS[c.enc_id][1]
    if c.deltas.is_cuda and name in UNIFORM_KERNEL_PARAMS:
        from repro_torch.kernels.bdi import ops as bdi_ops
        return bdi_ops.decompress(
            bo.sext(c.base, 32).to(torch.int32)[:, None], c.mask, c.deltas,
            enc=name, block_bytes=c.block_bytes, shape=c.shape,
            dtype=c.dtype_name)
    return tensor_from_bytes(_decode_uniform_blocks(c).reshape(-1),
                             c.dtype_name, c.shape)


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

    def original_bytes(self) -> int:
        return original_bytes(self.shape, self.dtype_name)

    def ratio(self) -> float:
        return self.original_bytes() / max(self.compressed_bytes(), 1)


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
    use_base = bo.fits_signed64(delta, db)  # reference's int64 encoder
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


def _decode_bd(rec: torch.Tensor, wb: int, db: int, B: int) -> torch.Tensor:
    """Base + delta records (uint8[n, >= enc_size]) -> uint8 bytes [n, B]."""
    W = B // wb
    mb = -(-W // 8)
    base = bo.unpack_low_bytes(rec[:, 1:1 + wb], 1, wb)[:, 0]
    return decode_bd(base, rec[:, 1 + wb:1 + wb + mb],
                     rec[:, 1 + wb + mb:1 + wb + mb + W * db], wb, db, B)


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
    rec = stream[idx]
    out = torch.zeros((nb, B), dtype=torch.uint8, device=stream.device)
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
    return out


def decompress_packed(c: BDIPacked) -> np.ndarray:
    """Host decode of a :class:`BDIPacked` -> the original array (bf16
    comes back as its uint16 bit patterns)."""
    blocks = decode_packed_blocks(torch.tensor(c.stream),
                                  torch.tensor(c.offsets),
                                  torch.tensor(c.enc), c.block_bytes)
    return from_bytes(blocks.numpy().reshape(-1), c.dtype_name, c.shape)


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's name of a dtype: 'int32', 'bfloat16', ..."""
    return str(dtype).removeprefix("torch.")


def original_bytes(shape, name: str) -> int:
    return math.prod(shape) * getattr(torch, name).itemsize


def tensor_from_bytes(flat_u8: torch.Tensor, name: str,
                      shape) -> torch.Tensor:
    """The first ``prod(shape)`` items of decoded bytes (uint8, any
    device) as a tensor of dtype ``name``."""
    n = original_bytes(shape, name)
    return flat_u8[:n].view(getattr(torch, name)).reshape(shape)


# convenience API --------------------------------------------------------------

def compress(x, mode: str = "uniform", **kw):
    if mode == "uniform":
        return compress_uniform(x, **kw)
    if mode == "packed":
        return compress_packed(x, **kw)
    raise ValueError(mode)


def decompress(c):
    if isinstance(c, BDIUniform):
        return decompress_uniform(c)
    if isinstance(c, BDIPacked):
        return decompress_packed(c)
    raise TypeError(type(c))


def from_bytes(flat_u8: np.ndarray, dtype_name: str, shape) -> np.ndarray:
    """The first ``prod(shape)`` items of decoded bytes as ``dtype_name``
    (``bfloat16`` as uint16 bit patterns: numpy has no bf16)."""
    dtype = np.dtype(np.uint16 if dtype_name == "bfloat16" else dtype_name)
    n = int(np.prod(shape)) * dtype.itemsize
    return flat_u8[:n].view(dtype).reshape(shape)
