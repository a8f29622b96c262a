"""FPC decode of a packed stream, behind one wrapper.

Counterpart of ``repro.kernels.fpc``.  Two forms behind
:func:`decompress_blocks`:

* the CUDA kernel (``csrc/fpc_decode.cu``, kernel 5 of the port's table,
  replacing ``repro.kernels.fpc.fpc.decompress_pallas``), launched for
  CUDA tensors on the current stream -- a failed build or launch raises;
* the plain PyTorch form (``repro_torch.assist.schemes.fpc
  .decode_blocks``), used only for CPU tensors and as the kernel's oracle
  on the card.

``LAUNCHES`` counts kernel launches (plain calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.assist.schemes import fpc as fpc_scheme
from repro_torch.kernels import build

KERNEL_SOURCE = "fpc/fpc_decode"
LAUNCHES = {"fpc_decode": 0}
MAX_SEGMENTS = 256            # the kernel's scan table


def reset_launches():
    LAUNCHES["fpc_decode"] = 0


def decompress_blocks(stream, offsets, seg_enc, *, out=None):
    """stream uint8[S]; offsets int32[nb]; seg_enc uint8[nb, nseg] ->
    uint8[nb, nseg * 32].

    ``out`` (uint8[nb, B], contiguous, 4-byte aligned) receives the blocks
    in place of a fresh tensor -- the cold tier decodes straight into its
    staging buffer."""
    nb, nseg = seg_enc.shape
    block_bytes = nseg * fpc_scheme.SEG_BYTES
    dev = stream.device
    build.require(stream.dim() == 1, "stream must be 1-D")
    build.require(0 < nseg <= MAX_SEGMENTS,
                  f"{nseg} segments per block (1..{MAX_SEGMENTS})")
    build.check_tensor(stream, "stream", dev, torch.uint8, stream.shape)
    build.check_tensor(offsets, "offsets", dev, torch.int32, (nb,))
    build.check_tensor(seg_enc, "seg_enc", dev, torch.uint8, (nb, nseg))
    if out is None:
        out = torch.empty((nb, block_bytes), dtype=torch.uint8, device=dev)
    build.check_tensor(out, "out", dev, torch.uint8, (nb, block_bytes))
    if dev.type == "cpu":
        out.copy_(fpc_scheme.decode_blocks(stream, offsets, seg_enc,
                                           block_bytes))
        return out
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    build.require(out.data_ptr() % 4 == 0, "out must be 4-byte aligned")
    if nb == 0:
        return out
    fn = build.function(KERNEL_SOURCE, "fpc_decode",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])
    rc = fn(build.ptr(stream), build.ptr(offsets), build.ptr(seg_enc),
            build.ptr(out), nb, nseg, build.stream_ptr(dev))
    build.raise_on(rc, "fpc_decode")
    LAUNCHES["fpc_decode"] += 1
    return out
