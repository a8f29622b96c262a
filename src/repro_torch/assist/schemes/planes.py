"""Byte-plane compression for >= 2-byte tensors (bf16, f32, int16, ...).

Counterpart of ``repro.assist.schemes.planes``.  A tensor's values split
into byte planes, per block of ``block_values`` values.  The HIGH plane
(sign and exponent of a float; the top byte of an int) has few distinct
bytes within a block, so it is stored as a dictionary of its first
``NDICT`` distinct bytes (in order of first appearance) and 4-bit codes
when the block has no more than ``NDICT``, else raw; the low planes
(mantissa bytes) are stored raw.  Lossless by construction.

Layout per block of V values:
  hi plane: dict[NDICT bytes] + 4-bit codes (V/2 bytes)  if <= NDICT distinct
            else raw V bytes
  lo plane: raw V * (itemsize - 1) bytes

The reference builds the dictionary by a serial scan over the block; here
each block's distinct bytes are sorted by first position, which gives the
same dictionary.  Plain PyTorch on the tensor's device (the reference has
no kernel for it); every field is byte-identical to the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.assist.schemes.bdi import dtype_name, original_bytes

NDICT = 16  # byte dictionary entries (4-bit codes)


@dataclasses.dataclass(frozen=True)
class PlanesTensor:
    ok: torch.Tensor        # bool[nblocks] -- hi plane fit in the dictionary?
    dict_: torch.Tensor     # uint8[nblocks, NDICT] (zeros past the count)
    codes: torch.Tensor     # uint8[nblocks, V/2] nibble-packed dict indices
    hi_raw: torch.Tensor    # uint8[nblocks, V] raw hi plane where !ok
    lo: torch.Tensor        # uint8[nblocks, V*(itemsize-1)] raw low planes
    shape: tuple
    dtype_name: str
    block_values: int
    pad: int

    @property
    def nblocks(self) -> int:
        return self.ok.shape[0]

    def compressed_bytes(self) -> int:
        nc = int(self.ok.sum())
        n = self.nblocks
        V = self.block_values
        return n + nc * (NDICT + V // 2) + (n - nc) * V + self.lo.numel()

    def original_bytes(self) -> int:
        return original_bytes(self.shape, self.dtype_name)

    def ratio(self) -> float:
        return self.original_bytes() / max(self.compressed_bytes(), 1)


def _split_planes(x: torch.Tensor, block_values: int):
    itemsize = x.element_size()
    if itemsize < 2:
        raise ValueError("planes scheme needs >=2-byte dtypes")
    b = x.contiguous().reshape(-1).view(torch.uint8).reshape(-1, itemsize)
    n = b.shape[0]
    nblocks = -(-n // block_values)
    pad = nblocks * block_values - n
    if pad:
        b = torch.cat([b, b.new_zeros((pad, itemsize))])
    b = b.reshape(nblocks, block_values, itemsize)
    hi = b[..., itemsize - 1]                      # little-endian: last = hi
    lo = b[..., :itemsize - 1].reshape(nblocks, -1)
    return hi, lo, pad


def _build_byte_dict(hi: torch.Tensor):
    """Each block's first NDICT distinct bytes in order of first
    appearance -> (dict uint8[nb, NDICT], count int64[nb])."""
    nb, V = hi.shape
    pos = torch.arange(V, device=hi.device).expand(nb, V)
    first = torch.full((nb, 256), V, dtype=torch.int64, device=hi.device)
    first.scatter_reduce_(1, hi.long(), pos, reduce="amin")
    order = torch.argsort(first, dim=1, stable=True)[:, :NDICT]
    valid = first.gather(1, order) < V
    dict_ = torch.where(valid, order, 0).to(torch.uint8)
    return dict_, valid.sum(dim=1)


def compress(x: torch.Tensor, block_values: int = 256) -> PlanesTensor:
    hi, lo, pad = _split_planes(x, block_values)
    dict_, count = _build_byte_dict(hi)
    nb = hi.shape[0]
    slots = torch.arange(NDICT, device=hi.device)
    valid = count[:, None] > slots[None, :]
    # code of each byte value: its dictionary slot, NDICT where it has none
    code_of = torch.full((nb, 257), NDICT, dtype=torch.int64,
                         device=hi.device)
    code_of.scatter_(1, torch.where(valid, dict_.long(), 256),
                     slots.expand(nb, NDICT))
    idx = code_of.gather(1, hi.long())
    ok = (idx < NDICT).all(dim=-1)
    idx = torch.where(ok[:, None], idx, 0).to(torch.uint8)
    codes = idx[:, 0::2] | (idx[:, 1::2] << 4)
    hi_raw = torch.where(ok[:, None], 0, hi).to(torch.uint8)
    return PlanesTensor(ok=ok, dict_=dict_, codes=codes, hi_raw=hi_raw,
                        lo=lo.contiguous(), shape=tuple(x.shape),
                        dtype_name=dtype_name(x.dtype),
                        block_values=block_values, pad=pad)


def decompress(c: PlanesTensor) -> torch.Tensor:
    nb, V = c.hi_raw.shape
    idx = torch.stack([c.codes & 0xF, c.codes >> 4], dim=-1).reshape(nb, V)
    from_dict = c.dict_.gather(1, idx.long())
    hi = torch.where(c.ok[:, None], from_dict, c.hi_raw)
    dtype = getattr(torch, c.dtype_name)
    itemsize = dtype.itemsize
    lo = c.lo.reshape(nb, V, itemsize - 1)
    full = torch.cat([lo, hi[..., None]], dim=-1)   # little-endian
    vals = full.reshape(-1).view(dtype)
    n = nb * V - c.pad
    return vals[:n].reshape(c.shape)
