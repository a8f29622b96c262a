"""Byte and word helpers of the lossless codecs (BDI, FPC, C-Pack).

Counterpart of ``repro.assist.bytesops``, with the same bit and byte
order (little-endian words, little-bit-endian masks).  Two families:

* numpy, on the host: :func:`words_of` and :func:`low_bytes`, which the
  packed BDI and FPC encoders use (the cold tier packs pages it has read
  back from the device);
* PyTorch, on the tensor's device: :func:`words_from_block` and the
  packing and range helpers below, which the uniform BDI codec, C-Pack
  and the plain forms of their kernels use.

:func:`to_bytes`, :func:`pad_to_blocks`, :func:`sext` and
:func:`fits_signed64` take either; :func:`host_array` carries a tensor
to the host codecs.
Words are carried in int64: 1-, 2- and 4-byte words zero-extended, 8-byte
words as their two's-complement value, so the reference's (lo, hi) uint32
pairs are not needed.  Arithmetic on 8-byte words wraps at 64 bits, as
the reference's carries do.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_BLOCK_BYTES = 512  # 256 bf16 values: the codecs' "cache line"

_U32 = 0xFFFFFFFF


def to_bytes(x):
    """Any array or tensor as its flat little-endian bytes (uint8)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8)
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def host_array(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array (bf16 as its uint16 bits),
    what the host codecs (packed BDI, FPC) take."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def pad_to_blocks(flat_u8, block_bytes: int):
    """Zero-pad flat bytes to whole blocks -> (uint8[nblocks, B], pad)."""
    n = flat_u8.shape[0]
    nblocks = -(-n // block_bytes)
    pad = nblocks * block_bytes - n
    if pad and isinstance(flat_u8, torch.Tensor):
        flat_u8 = torch.cat([flat_u8, flat_u8.new_zeros(pad)])
    elif pad:
        flat_u8 = np.concatenate([flat_u8, np.zeros(pad, np.uint8)])
    return flat_u8.reshape(nblocks, block_bytes), pad


def words_of(blocks: np.ndarray, word_bytes: int) -> np.ndarray:
    """uint8[..., B] -> int64[..., B / word_bytes] little-endian words
    (numpy; :func:`words_from_block` is the PyTorch form)."""
    b = np.ascontiguousarray(blocks)
    view = {1: "<u1", 2: "<u2", 4: "<u4", 8: "<i8"}[word_bytes]
    return b.view(view).astype(np.int64)


def low_bytes(v: np.ndarray, n_bytes: int) -> np.ndarray:
    """int64[..., W] -> its low ``n_bytes`` bytes, little-endian:
    uint8[..., W * n_bytes] (numpy; :func:`pack_low_bytes` is the PyTorch
    form)."""
    parts = [((v >> (8 * k)) & 0xFF).astype(np.uint8) for k in range(n_bytes)]
    return np.stack(parts, axis=-1).reshape(*v.shape[:-1],
                                            v.shape[-1] * n_bytes)


def sext(v, bits: int):
    """Sign-extend the low ``bits`` bits of an int64 array (numpy or torch)."""
    half = 1 << (bits - 1)
    return ((v & ((1 << bits) - 1)) ^ half) - half


# -- words <-> bytes (PyTorch) -------------------------------------------------

_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def word_dtype(word_bytes: int) -> torch.dtype:
    """The integer dtype that carries a word's bits (uint16 words as int16,
    uint32 as int32: the kernels' word layout)."""
    return _INT_OF_WIDTH[word_bytes]


def words_from_block(blk: torch.Tensor, word_bytes: int) -> torch.Tensor:
    """uint8[..., B] -> int64[..., B / word_bytes] little-endian words:
    zero-extended for 1, 2 and 4 bytes, two's complement for 8."""
    w = blk.contiguous().view(_INT_OF_WIDTH[word_bytes]).long()
    return w if word_bytes in (1, 8) else w & ((1 << (8 * word_bytes)) - 1)


def block_from_words(words: torch.Tensor, word_bytes: int,
                     block_bytes: int) -> torch.Tensor:
    """Inverse of :func:`words_from_block` (each word truncated to its
    width): -> uint8[..., block_bytes]."""
    if word_bytes == 1:
        w = words & 0xFF
    else:
        w = words if word_bytes == 8 else sext(words, 8 * word_bytes)
    b = w.to(_INT_OF_WIDTH[word_bytes]).contiguous().view(torch.uint8)
    return b.reshape(*words.shape[:-1], block_bytes)


# -- signed-range checks and sign extension -------------------------------------

def fits_signed32(u: torch.Tensor, d_bytes: int) -> torch.Tensor:
    """Where the 32-bit two's-complement value carried in ``u`` (the low 32
    bits) fits in ``d_bytes`` signed bytes: ``(u + half) < 2^(8d)`` with
    uint32 wraparound, as the reference."""
    if d_bytes >= 4:
        return torch.ones(u.shape, dtype=torch.bool, device=u.device)
    half, full = 1 << (8 * d_bytes - 1), 1 << (8 * d_bytes)
    return ((u + half) & _U32) < full


def fits_signed64(v, d_bytes: int):
    """Where the int64 value ``v`` (numpy or torch) fits in ``d_bytes``
    signed bytes."""
    lim = 1 << (8 * d_bytes - 1)
    return (v >= -lim) & (v < lim)


def sext32(u: torch.Tensor, d_bytes: int) -> torch.Tensor:
    """The low ``d_bytes`` of ``u`` sign-extended to a uint32 carrier (an
    int64 in [0, 2^32))."""
    if d_bytes >= 4:
        return u
    return sext(u, 8 * d_bytes) & _U32


# -- bit / byte packing (PyTorch) ----------------------------------------------

def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., W] -> uint8[..., ceil(W/8)], little-bit-endian."""
    W = bits.shape[-1]
    Wp = -(-W // 8) * 8
    b = bits.to(torch.uint8)
    if Wp != W:
        b = torch.cat([b, b.new_zeros((*b.shape[:-1], Wp - W))], dim=-1)
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                           device=b.device)
    g = b.reshape(*b.shape[:-1], Wp // 8, 8) * weights
    return g.sum(dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor, W: int) -> torch.Tensor:
    """uint8[..., ceil(W/8)] -> bool[..., W]."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :W].bool()


def pack_low_bytes(u: torch.Tensor, d_bytes: int) -> torch.Tensor:
    """int64[..., W] -> its low ``d_bytes`` bytes, little-endian:
    uint8[..., W * d_bytes]."""
    parts = [((u >> (8 * k)) & 0xFF) for k in range(d_bytes)]
    out = torch.stack(parts, dim=-1).to(torch.uint8)
    return out.reshape(*u.shape[:-1], u.shape[-1] * d_bytes)


def unpack_low_bytes(b: torch.Tensor, W: int, d_bytes: int) -> torch.Tensor:
    """Inverse of :func:`pack_low_bytes`: uint8[..., W * d_bytes] ->
    int64[..., W], zero-extended (8 bytes: two's complement)."""
    g = b.reshape(*b.shape[:-1], W, d_bytes).long()
    out = g[..., 0]
    for k in range(1, d_bytes):
        out = out | (g[..., k] << (8 * k))
    return out
