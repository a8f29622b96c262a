"""Byte and word helpers of the lossless codecs (BDI, FPC), on the host.

Counterpart of ``repro.assist.bytesops`` for what the port's codecs use.
The encoders run on the host over numpy arrays (the cold tier packs pages
it has read back from the device), so these helpers are numpy; the plain
decoders are PyTorch and use :func:`sext`, which takes either.  Words are
carried in int64, so the reference's (lo, hi) uint32 pairs for 8-byte
words are not needed here.
"""
from __future__ import annotations

import numpy as np

DEFAULT_BLOCK_BYTES = 512  # 256 bf16 values: the codecs' "cache line"


def to_bytes(x: np.ndarray) -> np.ndarray:
    """Any array as its flat little-endian bytes (uint8[x.nbytes])."""
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def pad_to_blocks(flat_u8: np.ndarray, block_bytes: int):
    """Zero-pad flat bytes to whole blocks -> (uint8[nblocks, B], pad)."""
    n = flat_u8.shape[0]
    nblocks = -(-n // block_bytes)
    pad = nblocks * block_bytes - n
    if pad:
        flat_u8 = np.concatenate([flat_u8, np.zeros(pad, np.uint8)])
    return flat_u8.reshape(nblocks, block_bytes), pad


def words_of(blocks: np.ndarray, word_bytes: int) -> np.ndarray:
    """uint8[..., B] -> int64[..., B / word_bytes] little-endian words.

    Words of 1, 2 and 4 bytes are zero-extended; 8-byte words are their
    two's-complement int64 value (as the reference's numpy encoder builds
    them with int64 shifts)."""
    b = np.ascontiguousarray(blocks)
    view = {1: "<u1", 2: "<u2", 4: "<u4", 8: "<i8"}[word_bytes]
    return b.view(view).astype(np.int64)


def low_bytes(v: np.ndarray, n_bytes: int) -> np.ndarray:
    """int64[..., W] -> its low ``n_bytes`` bytes, little-endian:
    uint8[..., W * n_bytes]."""
    parts = [((v >> (8 * k)) & 0xFF).astype(np.uint8) for k in range(n_bytes)]
    return np.stack(parts, axis=-1).reshape(*v.shape[:-1],
                                            v.shape[-1] * n_bytes)


def sext(v, bits: int):
    """Sign-extend the low ``bits`` bits of an int64 array (numpy or torch)."""
    half = 1 << (bits - 1)
    return ((v & ((1 << bits) - 1)) ^ half) - half
