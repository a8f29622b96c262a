"""Variable-rate BDI decode of a packed stream, behind one wrapper.

Counterpart of ``repro.kernels.bdi`` for the packed (per-block encoding)
format the cold tier writes.  Two forms behind
:func:`decompress_packed_blocks`:

* the CUDA kernel (``csrc/bdi_packed_decode.cu``, kernel 4 of the port's
  table, replacing ``repro.kernels.bdi.bdi.decompress_packed_pallas``),
  launched for CUDA tensors on the current stream -- a failed build or
  launch raises;
* the plain PyTorch form (``repro_torch.assist.schemes.bdi
  .decode_packed_blocks``), used only for CPU tensors and as the kernel's
  oracle on the card.

Both decode all nine encoding ids, the 8-byte-word ones included.
``LAUNCHES`` counts kernel launches (plain calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.assist.schemes import bdi as bdi_scheme
from repro_torch.kernels import build

KERNEL_SOURCE = "bdi/bdi_packed_decode"
LAUNCHES = {"bdi_packed_decode": 0}


def reset_launches():
    LAUNCHES["bdi_packed_decode"] = 0


def decompress_packed_blocks(stream, offsets, enc, *, block_bytes: int = 512,
                             out=None):
    """stream uint8[S]; offsets int32[nb]; enc uint8[nb] -> uint8[nb, B].

    ``out`` (uint8[nb, B], contiguous, 4-byte aligned) receives the blocks
    in place of a fresh tensor -- the cold tier decodes straight into its
    staging buffer."""
    nb = offsets.shape[0]
    dev = stream.device
    build.require(block_bytes > 0 and block_bytes % 8 == 0,
                  f"block_bytes {block_bytes} must be a multiple of 8")
    build.require(stream.dim() == 1, "stream must be 1-D")
    build.check_tensor(stream, "stream", dev, torch.uint8, stream.shape)
    build.check_tensor(offsets, "offsets", dev, torch.int32, (nb,))
    build.check_tensor(enc, "enc", dev, torch.uint8, (nb,))
    if out is None:
        out = torch.empty((nb, block_bytes), dtype=torch.uint8, device=dev)
    build.check_tensor(out, "out", dev, torch.uint8, (nb, block_bytes))
    if dev.type == "cpu":
        out.copy_(bdi_scheme.decode_packed_blocks(stream, offsets, enc,
                                                  block_bytes))
        return out
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    build.require(out.data_ptr() % 4 == 0, "out must be 4-byte aligned")
    if nb == 0:
        return out
    fn = build.function(KERNEL_SOURCE, "bdi_packed_decode",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])
    rc = fn(build.ptr(stream), build.ptr(offsets), build.ptr(enc),
            build.ptr(out), nb, block_bytes, build.stream_ptr(dev))
    build.raise_on(rc, "bdi_packed_decode")
    LAUNCHES["bdi_packed_decode"] += 1
    return out
