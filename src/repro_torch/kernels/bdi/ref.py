"""Plain PyTorch forms of the uniform BDI kernels (kernel-native layout).

Counterpart of ``repro.kernels.bdi.ref``.  The kernel layout specializes
the scheme-level :class:`~repro_torch.assist.schemes.bdi.BDIUniform` to
the encodings that fire on ML tensors:

  b2d1: 2-byte words, 1-byte deltas (bf16 bit patterns)  W = B/2
  b4d1: 4-byte words, 1-byte deltas (fp32/int32)         W = B/4
  b4d2: 4-byte words, 2-byte deltas                      W = B/4

Layout per block of B bytes:
  base  : int32[nb, 1]       the block's first word (uint32 bits)
  mask  : uint8[nb, W/8]     little-bit-endian base-vs-zero selector
  deltas: uint8[nb, W*d]     little-endian low bytes of the selected value

:func:`decompress_ref` is the plain form of the decode kernel and
:func:`compress_ref` that of the encode kernel; both run on any device.
"""
from __future__ import annotations

import torch

from repro_torch.assist import bytesops as bo
from repro_torch.assist.schemes import bdi as bdi_scheme

ENC_PARAMS = bdi_scheme.UNIFORM_KERNEL_PARAMS


def decompress_ref(base, mask, deltas, enc: str, block_bytes: int):
    """-> uint8[nb, block_bytes]."""
    wb, db = ENC_PARAMS[enc]
    return bdi_scheme.decode_bd(base[:, 0].long() & 0xFFFFFFFF, mask, deltas,
                                wb, db, block_bytes)


def compress_ref(blocks, enc: str):
    """uint8[nb, B] -> (base int32[nb, 1], mask uint8[nb, W/8], deltas
    uint8[nb, W*d], ok bool[nb]).  ``ok``: every word fits under the base
    or the zero base."""
    base, mask, deltas, ok = bdi_scheme.encode_bd(blocks, *ENC_PARAMS[enc])
    return bo.sext(base, 32).to(torch.int32)[:, None], mask, deltas, ok


def layout_from_uniform(x, enc: str, block_bytes: int = 512):
    """Compress tensor ``x`` into the kernel-native layout (plain form)."""
    blocks, pad = bo.pad_to_blocks(bo.to_bytes(x), block_bytes)
    base, mask, deltas, ok = compress_ref(blocks, enc)
    return dict(base=base, mask=mask, deltas=deltas, ok=ok, pad=pad,
                shape=tuple(x.shape), dtype=bdi_scheme.dtype_name(x.dtype),
                enc=enc, block_bytes=block_bytes)


def tensor_from_layout(layout) -> torch.Tensor:
    blocks = decompress_ref(layout["base"], layout["mask"], layout["deltas"],
                            layout["enc"], layout["block_bytes"])
    return bdi_scheme.tensor_from_bytes(blocks.reshape(-1), layout["dtype"],
                                        layout["shape"])
