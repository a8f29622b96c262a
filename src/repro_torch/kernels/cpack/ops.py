"""C-Pack decode behind one wrapper.

Counterpart of ``repro.kernels.cpack.ops``.  Two forms behind
:func:`decompress_blocks`:

* the CUDA kernel (``csrc/cpack_decode.cu``, kernel 10 of the port's
  table, replacing ``repro.kernels.cpack.cpack.decompress_pallas``),
  launched for CUDA tensors on the current stream -- a failed build or
  launch raises;
* the plain PyTorch form (``repro_torch.assist.schemes.cpack
  .decode_blocks``), used only for CPU tensors and as the kernel's oracle
  on the card.

Any block count is taken.  ``LAUNCHES`` counts kernel launches (plain
calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.assist.schemes import bdi as bdi_scheme
from repro_torch.assist.schemes import cpack as cpack_scheme
from repro_torch.assist.schemes.cpack import CPacked
from repro_torch.kernels import build

KERNEL_SOURCE = "cpack/cpack_decode"
LAUNCHES = {"cpack_decode": 0}


def reset_launches():
    LAUNCHES["cpack_decode"] = 0


def decompress_blocks(ok, dict_, codes, payload, raw):
    """ok bool[nb]; dict_ int32[nb, 4] (uint32 bits); codes uint8[nb, W/2];
    payload uint8[nb, W]; raw uint8[nb, 4W] -> uint8[nb, 4W]."""
    nb, W = payload.shape
    dev = payload.device
    build.require(W > 0 and W % 2 == 0, f"W {W} words must be even")
    build.check_tensor(ok, "ok", dev, torch.bool, (nb,))
    build.check_tensor(dict_, "dict_", dev, torch.int32,
                       (nb, cpack_scheme.NDICT))
    build.check_tensor(codes, "codes", dev, torch.uint8, (nb, W // 2))
    build.check_tensor(payload, "payload", dev, torch.uint8, (nb, W))
    build.check_tensor(raw, "raw", dev, torch.uint8,
                       (nb, W * cpack_scheme.WORD_BYTES))
    if dev.type == "cpu":
        return cpack_scheme.decode_blocks(ok, dict_, codes, payload, raw)
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    build.require(raw.data_ptr() % 4 == 0, "raw must be 4-byte aligned")
    out = torch.empty_like(raw)
    if nb == 0:
        return out
    fn = build.function(KERNEL_SOURCE, "cpack_decode",
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])
    rc = fn(build.ptr(ok), build.ptr(dict_), build.ptr(codes),
            build.ptr(payload), build.ptr(raw), build.ptr(out), nb, W,
            build.stream_ptr(dev))
    build.raise_on(rc, "cpack_decode")
    LAUNCHES["cpack_decode"] += 1
    return out


def decompress(c: CPacked) -> torch.Tensor:
    """A :class:`CPacked` -> the original tensor on its device."""
    blocks = decompress_blocks(c.ok, c.dict_, c.codes, c.payload, c.raw)
    return bdi_scheme.tensor_from_bytes(blocks.reshape(-1), c.dtype_name,
                                        c.shape)
