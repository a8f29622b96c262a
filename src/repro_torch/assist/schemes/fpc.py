"""Frequent Pattern Compression, segment-parallel (paper 5.1.4).

Counterpart of ``repro.assist.schemes.fpc``: 4-byte words, a 512 B block
is 16 segments of 8 words, every word of a segment shares one of 8
patterns (zero, 4/8/16-bit sign-extended, upper halfword, two
sign-extended bytes, repeated byte, raw), the patterns sit at the head of
the block and the payloads follow back to back.

The encoder runs on the host in numpy, vectorized over segments, and gives
the reference's bytes exactly: the cheapest-first pattern order with its
stable tie-break, payloads, offsets and the ``B + 32`` over-fetch padding.
The plain decoder is PyTorch (:func:`decode_blocks`): the oracle of the
CUDA kernel in ``repro_torch.kernels.fpc`` and the form it takes for CPU
tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.assist import bytesops as bo
from repro_torch.assist.schemes.bdi import from_bytes, original_bytes

WORD_BYTES = 4
SEG_WORDS = 8
SEG_BYTES = SEG_WORDS * WORD_BYTES  # 32 B

# pattern id -> (name, payload bytes per word)
PATTERNS: tuple[tuple[int, str, float], ...] = (
    (0, "zero", 0.0),
    (1, "se4", 0.5),
    (2, "se8", 1.0),
    (3, "se16", 2.0),
    (4, "hi_half", 2.0),   # lower halfword zero, upper halfword data
    (5, "two_se8", 2.0),   # each halfword is a sign-extended byte
    (6, "rep_byte", 1.0),  # word == one byte repeated 4x
    (7, "raw", 4.0),
)


def seg_payload_bytes(pat: int) -> int:
    return int(PATTERNS[pat][2] * SEG_WORDS)


SEG_SIZES = np.array([seg_payload_bytes(p) for p, *_ in PATTERNS], np.int64)


def _word_fits(w: np.ndarray) -> dict[int, np.ndarray]:
    """Per-word pattern feasibility; w: int64 words in [0, 2^32)."""
    def fits_se(bits):
        return ((w + (1 << (bits - 1))) & 0xFFFFFFFF) < (1 << bits)

    def fits_se16(h):
        b = h & 0xFF
        return h == np.where(b >= 0x80, b | 0xFF00, b)

    b0 = w & 0xFF
    return {0: w == 0, 1: fits_se(4), 2: fits_se(8), 3: fits_se(16),
            4: (w & 0xFFFF) == 0,
            5: fits_se16(w & 0xFFFF) & fits_se16(w >> 16),
            6: w == b0 * 0x01010101,
            7: np.ones(w.shape, bool)}


def analyze_segments(blocks: np.ndarray) -> np.ndarray:
    """uint8[nblocks, nseg]: the best (smallest) pattern of each segment;
    among equal sizes the lower id (a stable cheapest-first order)."""
    nblocks, B = blocks.shape
    w = bo.words_of(blocks, WORD_BYTES).reshape(nblocks, B // SEG_BYTES,
                                                SEG_WORDS)
    fits = _word_fits(w)
    order = np.argsort(SEG_SIZES, kind="stable")       # cheapest first
    best = np.full(w.shape[:2], 7, np.int64)
    for pat in order[::-1]:                            # overwrite w/ cheaper
        best = np.where(np.all(fits[int(pat)], axis=-1), pat, best)
    return best.astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class FPCPacked:
    """Variable-rate FPC: per-segment patterns, payload stream with
    per-block offsets (host arrays)."""
    seg_enc: np.ndarray   # uint8[nblocks, nseg]
    stream: np.ndarray    # uint8[stream_bytes + block_bytes + SEG_BYTES]
    offsets: np.ndarray   # int32[nblocks]
    shape: tuple
    dtype_name: str
    block_bytes: int
    pad: int
    stream_bytes: int

    @property
    def nblocks(self) -> int:
        return self.seg_enc.shape[0]

    def compressed_bytes(self) -> int:
        # nibble-packed prefixes (the paper stores 3 bits; 4 are charged)
        return (self.stream_bytes + self.seg_enc.size // 2
                + self.offsets.size * 4)

    def original_bytes(self) -> int:
        return original_bytes(self.shape, self.dtype_name)

    def ratio(self) -> float:
        return self.original_bytes() / max(self.compressed_bytes(), 1)


def _encode_segments_np(w: np.ndarray, pat: int) -> np.ndarray:
    """int64 words [n, SEG_WORDS] -> payload bytes uint8[n, size(pat)]."""
    n = w.shape[0]

    def byte(k):
        return ((w >> (8 * k)) & 0xFF).astype(np.uint8)

    if pat == 1:                       # two words per byte, low nibble first
        nib = (w & 0xF).astype(np.uint8)
        return nib[:, 0::2] | (nib[:, 1::2] << 4)
    if pat in (2, 6):
        return byte(0)
    if pat in (3, 4, 5):
        k0, k1 = {3: (0, 1), 4: (2, 3), 5: (0, 2)}[pat]
        return np.stack([byte(k0), byte(k1)], axis=-1).reshape(n, -1)
    if pat == 7:
        return bo.low_bytes(w, 4)
    raise ValueError(pat)


def compress(x: np.ndarray,
             block_bytes: int = bo.DEFAULT_BLOCK_BYTES) -> FPCPacked:
    """Host FPC compression (paper Alg. 4: best pattern per segment, the
    segment addresses as a prefix sum)."""
    x = np.asarray(x)
    blocks, pad = bo.pad_to_blocks(bo.to_bytes(x), block_bytes)
    nblocks, B = blocks.shape
    seg_enc = analyze_segments(blocks)
    w = bo.words_of(blocks, WORD_BYTES).reshape(nblocks, B // SEG_BYTES,
                                                SEG_WORDS)
    sizes = SEG_SIZES[seg_enc]                          # [nb, nseg]
    asz = -(-sizes.sum(axis=1) // 4) * 4
    offsets = np.zeros(nblocks, np.int64)
    offsets[1:] = np.cumsum(asz)[:-1]
    total = int(offsets[-1] + asz[-1]) if nblocks else 0
    seg_off = offsets[:, None] + np.cumsum(sizes, axis=1) - sizes
    # pad by the decoder's over-fetch window (a block plus one segment)
    stream = np.zeros(total + block_bytes + SEG_BYTES, np.uint8)
    for pat in range(1, len(PATTERNS)):
        sel = seg_enc == pat
        if sel.any():
            payload = _encode_segments_np(w[sel], pat)
            stream[seg_off[sel][:, None]
                   + np.arange(payload.shape[1])] = payload
    return FPCPacked(seg_enc=seg_enc, stream=stream,
                     offsets=offsets.astype(np.int32), shape=tuple(x.shape),
                     dtype_name=str(x.dtype), block_bytes=block_bytes,
                     pad=pad, stream_bytes=total)


def _decode_segments(q: torch.Tensor, pat: int) -> torch.Tensor:
    """Payload bytes int64[n, SEG_BYTES] (over-fetched) -> int64 words
    [n, SEG_WORDS] (as two's complement where a pattern sign-extends)."""
    n = q.shape[0]
    if pat == 1:
        nib = torch.stack([q[:, :4] & 0xF, (q[:, :4] >> 4) & 0xF], dim=-1)
        return bo.sext(nib.reshape(n, SEG_WORDS), 4)
    if pat == 2:
        return bo.sext(q[:, :SEG_WORDS], 8)
    if pat in (3, 4):
        h = q[:, 0:16:2] | (q[:, 1:16:2] << 8)
        return bo.sext(h, 16) if pat == 3 else h << 16
    if pat == 5:
        lo = bo.sext(q[:, 0:16:2], 8) & 0xFFFF
        hi = bo.sext(q[:, 1:16:2], 8) & 0xFFFF
        return lo | (hi << 16)
    if pat == 6:
        return q[:, :SEG_WORDS] * 0x01010101
    if pat == 7:
        return (q[:, 0::4] | (q[:, 1::4] << 8) | (q[:, 2::4] << 16)
                | (q[:, 3::4] << 24))
    raise ValueError(pat)


def decode_blocks(stream: torch.Tensor, offsets: torch.Tensor,
                  seg_enc: torch.Tensor,
                  block_bytes: int = bo.DEFAULT_BLOCK_BYTES) -> torch.Tensor:
    """Plain PyTorch FPC decode on any device (paper Alg. 3).

    stream uint8[S]; offsets int32[nb]; seg_enc uint8[nb, nseg] ->
    uint8[nb, B].  Segment offsets are the exclusive scan of the pattern
    sizes; each segment's 32 bytes are fetched (the stream's padding keeps
    the over-fetch in bounds) and expanded by its pattern."""
    nb, nseg = seg_enc.shape
    dev = stream.device
    pats = seg_enc.long()
    sz = torch.from_numpy(SEG_SIZES).to(dev)[pats]
    seg_off = offsets.long()[:, None] + torch.cumsum(sz, dim=1) - sz
    q = stream[seg_off[..., None] + torch.arange(SEG_BYTES, device=dev)]
    q = q.long()
    words = torch.zeros((nb, nseg, SEG_WORDS), dtype=torch.int64,
                        device=dev)
    for pat in range(1, len(PATTERNS)):
        sel = pats == pat
        if bool(sel.any()):
            words[sel] = _decode_segments(q[sel], pat)
    b = (words[..., None] >> torch.tensor([0, 8, 16, 24], device=dev)) & 0xFF
    return b.reshape(nb, block_bytes).to(torch.uint8)


def decompress(c: FPCPacked) -> np.ndarray:
    """Host decode of an :class:`FPCPacked` -> the original array (bf16
    comes back as its uint16 bit patterns)."""
    blocks = decode_blocks(torch.tensor(c.stream), torch.tensor(c.offsets),
                           torch.tensor(c.seg_enc), c.block_bytes)
    return from_bytes(blocks.numpy().reshape(-1), c.dtype_name, c.shape)
