"""C-Pack compression (paper 5.1.4), with the paper's simplifications.

Counterpart of ``repro.assist.schemes.cpack``:

* encodings: zero value, full dictionary match, partial match (only the
  last byte differs), zero-extend (only the last byte nonzero), and the
  uncompressed block as fallback;
* a 4-entry dictionary -> a fixed compressed word size (4-bit code + 1 B
  payload), so every word of a block decodes in parallel;
* the dictionary is built serially from the front of the block: a word
  becomes an entry if no entry covers it (paper Alg. 6) -- a loop over
  word positions, vectorized across blocks;
* a block needing more than 4 entries stays uncompressed.

Word size 4 bytes.  Fixed layout per compressible block of W words:
  [dict: 4 x 4 B] [codes: 4 bits x W] [payload: 1 B x W]
Codes: 0 zero | 1..4 full match d0..d3 | 5..8 partial match d0..d3 | 9 zext.

The encoder runs as PyTorch ops on the tensor's device and gives the
reference's bytes: ``ok``, the dictionary, codes, payload and ``raw``
(zero where ``ok``).  Words are int64 carriers of the uint32 values;
the dictionary is stored as int32 (uint32 bits), the kernel's layout.
:func:`decode_blocks` is the plain decoder, the oracle of the C-Pack
decode kernel in ``repro_torch.kernels.cpack``; :func:`decompress` runs
that kernel for CUDA tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.assist import bytesops as bo
from repro_torch.assist.schemes.bdi import (dtype_name, original_bytes,
                                            tensor_from_bytes)

WORD_BYTES = 4
NDICT = 4

CODE_ZERO = 0
CODE_FULL0 = 1   # ..4
CODE_PART0 = 5   # ..8
CODE_ZEXT = 9


def compressed_block_bytes(block_bytes: int) -> int:
    W = block_bytes // WORD_BYTES
    return NDICT * WORD_BYTES + W // 2 + W  # dict + nibble codes + payload


@dataclasses.dataclass(frozen=True)
class CPacked:
    """Fixed-rate C-Pack.  ``ok[i]`` selects compressed vs raw block ``i``;
    ``raw`` keeps the uncompressible blocks, and :meth:`compressed_bytes`
    charges each block its true cost."""
    ok: torch.Tensor        # bool[nblocks]
    dict_: torch.Tensor     # int32[nblocks, 4]  (uint32 bits)
    codes: torch.Tensor     # uint8[nblocks, W/2]  (nibble-packed)
    payload: torch.Tensor   # uint8[nblocks, W]
    raw: torch.Tensor       # uint8[nblocks, B]  (zeros where ok)
    shape: tuple
    dtype_name: str
    block_bytes: int
    pad: int

    @property
    def nblocks(self) -> int:
        return self.ok.shape[0]

    def compressed_bytes(self) -> int:
        nc = int(self.ok.sum())
        n = self.nblocks
        cb = compressed_block_bytes(self.block_bytes)
        return n + nc * cb + (n - nc) * self.block_bytes  # +1 B/blk metadata

    def original_bytes(self) -> int:
        return original_bytes(self.shape, self.dtype_name)

    def ratio(self) -> float:
        return self.original_bytes() / max(self.compressed_bytes(), 1)


def _covers(w: torch.Tensor, entry: torch.Tensor) -> torch.Tensor:
    """Is word ``w`` covered by dictionary entry (full or partial match)?"""
    return (w == entry) | ((w >> 8) == (entry >> 8))


def _self_covered(w: torch.Tensor) -> torch.Tensor:
    """Zero or zero-extend words never take a dictionary slot."""
    return (w == 0) | ((w >> 8) == 0)


def build_dictionary(w32: torch.Tensor):
    """w32: int64[nb, W] (uint32 values) -> (dict int64[nb, 4], n_entries
    int64[nb]).  Serial front-to-back scan (paper Alg. 6)."""
    nb, W = w32.shape
    dict_ = w32.new_zeros((nb, NDICT))
    count = w32.new_zeros((nb,))
    slots = torch.arange(NDICT, device=w32.device)
    for i in range(W):
        wi = w32[:, i]
        covered = _self_covered(wi)
        for k in range(NDICT):
            covered = covered | (_covers(wi, dict_[:, k]) & (count > k))
        need = ~covered & (count < NDICT)
        onehot = (slots[None, :] == count[:, None]) & need[:, None]
        dict_ = torch.where(onehot, wi[:, None], dict_)
        count = count + need.long()
    return dict_, count


def _assign_codes(w32: torch.Tensor, dict_: torch.Tensor,
                  count: torch.Tensor):
    """codes uint8[nb, W], payload uint8[nb, W], ok bool[nb]."""
    codes = torch.full(w32.shape, 255, dtype=torch.uint8, device=w32.device)
    payload = torch.zeros(w32.shape, dtype=torch.uint8, device=w32.device)
    low = (w32 & 0xFF).to(torch.uint8)
    valid = count[:, None] > torch.arange(NDICT, device=w32.device)[None, :]
    # priority: zero > full > zext > partial (cheapest information first);
    # lower priorities are written first so higher ones overwrite them
    for k in reversed(range(NDICT)):
        hit = ((w32 >> 8) == (dict_[:, k:k + 1] >> 8)) & valid[:, k:k + 1]
        codes = torch.where(hit, CODE_PART0 + k, codes)
        payload = torch.where(hit, low, payload)
    zext = (w32 >> 8) == 0
    codes = torch.where(zext, CODE_ZEXT, codes)
    payload = torch.where(zext, low, payload)
    for k in reversed(range(NDICT)):
        hit = (w32 == dict_[:, k:k + 1]) & valid[:, k:k + 1]
        codes = torch.where(hit, CODE_FULL0 + k, codes)
        payload = torch.where(hit, 0, payload)
    zero = w32 == 0
    codes = torch.where(zero, CODE_ZERO, codes)
    payload = torch.where(zero, 0, payload)
    ok = (codes != 255).all(dim=-1)  # the paper's global predicate AND
    codes = torch.where(ok[:, None], codes, 0)
    return codes, payload, ok


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


def _unpack_nibbles(nib: torch.Tensor, W: int) -> torch.Tensor:
    out = torch.stack([nib & 0xF, nib >> 4], dim=-1)
    return out.reshape(*nib.shape[:-1], W)


def compress(x: torch.Tensor,
             block_bytes: int = bo.DEFAULT_BLOCK_BYTES) -> CPacked:
    """Fixed-rate C-Pack compression, on ``x``'s device."""
    blocks, pad = bo.pad_to_blocks(bo.to_bytes(x), block_bytes)
    w32 = bo.words_from_block(blocks, WORD_BYTES)
    dict_, count = build_dictionary(w32)
    codes, payload, ok = _assign_codes(w32, dict_, count)
    raw = torch.where(ok[:, None], 0, blocks)
    return CPacked(ok=ok, dict_=bo.sext(dict_, 32).to(torch.int32),
                   codes=_pack_nibbles(codes), payload=payload, raw=raw,
                   shape=tuple(x.shape), dtype_name=dtype_name(x.dtype),
                   block_bytes=block_bytes, pad=pad)


def decode_blocks(ok: torch.Tensor, dict_: torch.Tensor, codes: torch.Tensor,
                  payload: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch C-Pack decode (paper Alg. 5) on any device -> the
    blocks, uint8[nb, B].  Codes 10-15 decode to zero."""
    W = payload.shape[-1]
    c = _unpack_nibbles(codes, W).long()
    pay = payload.long()
    d = dict_.long() & 0xFFFFFFFF
    dfull = torch.gather(d, 1, (c - CODE_FULL0).clamp(0, NDICT - 1))
    dpart = torch.gather(d, 1, (c - CODE_PART0).clamp(0, NDICT - 1))
    w = torch.zeros_like(c)
    w = torch.where((c >= CODE_FULL0) & (c < CODE_FULL0 + NDICT), dfull, w)
    w = torch.where((c >= CODE_PART0) & (c < CODE_PART0 + NDICT),
                    (dpart & 0xFFFFFF00) | pay, w)
    w = torch.where(c == CODE_ZEXT, pay, w)
    dec = bo.block_from_words(w, WORD_BYTES, raw.shape[-1])
    return torch.where(ok[:, None], dec, raw)


def decompress(c: CPacked) -> torch.Tensor:
    """The original tensor, on the codec's device: the C-Pack decode
    kernel for CUDA tensors, :func:`decode_blocks` for CPU ones."""
    from repro_torch.kernels.cpack import ops as cpack_ops
    return cpack_ops.decompress(c)
