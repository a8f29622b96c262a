"""BDI kernels behind their wrappers: packed decode, uniform decode and
encode.

Counterpart of ``repro.kernels.bdi``.  Each wrapper takes its plain
PyTorch form for CPU tensors (and it is the kernel's oracle on the card)
and launches its CUDA kernel for CUDA tensors on the current stream -- a
failed build or launch raises, nothing falls back:

* :func:`decompress_packed_blocks` -- the variable-rate decode of the
  packed format the cold tier writes (``csrc/bdi_packed_decode.cu``,
  kernel 4 of the port's table, replacing ``decompress_packed_pallas``;
  plain form ``schemes.bdi.decode_packed_blocks``).  It decodes all nine
  encoding ids, the 8-byte-word ones included;
* :func:`decompress_words` / :func:`decompress` -- the fixed-encoding
  decode of the uniform layout (``csrc/bdi_uniform.cu``, kernel 8,
  replacing ``decompress_pallas``; plain form ``ref.decompress_ref``);
* :func:`compress` -- the fixed-encoding encode (``csrc/bdi_uniform.cu``,
  kernel 9, replacing ``compress_pallas``; plain form
  ``ref.compress_ref``).

The uniform kernels take b2d1, b4d1 and b4d2 and any block count; words
are carried as int16 (uint16 bits) or int32 (uint32 bits), and so is the
base.  ``LAUNCHES`` counts kernel launches (plain calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.assist import bytesops as bo
from repro_torch.assist.schemes import bdi as bdi_scheme
from repro_torch.kernels import build
from repro_torch.kernels.bdi import ref as bdi_ref

KERNEL_SOURCE = "bdi/bdi_packed_decode"
UNIFORM_SOURCE = "bdi/bdi_uniform"
LAUNCHES = {"bdi_packed_decode": 0, "bdi_uniform_decode": 0,
            "bdi_uniform_encode": 0}
# encoding ids the packed kernel path emits (no 8-byte words), as the
# reference's; the port's packed kernel decodes all nine ids regardless
KERNEL_ENCODINGS = tuple(
    bdi_scheme.ENC_BY_NAME[n][0]
    for n in ("zeros", "rep8", "b4d1", "b4d2", "b2d1"))


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def compress_packed_for_kernel(x, block_bytes: int = 512):
    """Host-side variable-rate compression restricted to the encodings
    the reference's packed kernel takes."""
    return bdi_scheme.compress_packed(x, block_bytes=block_bytes,
                                      allowed=KERNEL_ENCODINGS)


# -- uniform layout: kernels 8 (decode) and 9 (encode) ------------------------

def _uniform_params(enc: str, block_bytes: int) -> tuple[int, int, int]:
    """(word_bytes, delta_bytes, W) of a kernel encoding; W words per block
    must be a multiple of 32 (whole warps, whole mask words), at most 1024
    (one encode CTA)."""
    build.require(enc in bdi_ref.ENC_PARAMS,
                  f"no uniform kernel for encoding {enc!r} (have "
                  f"{sorted(bdi_ref.ENC_PARAMS)})")
    wb, db = bdi_ref.ENC_PARAMS[enc]
    W = block_bytes // wb
    build.require(block_bytes % (32 * wb) == 0 and 0 < W <= 1024,
                  f"block_bytes {block_bytes} must give 32..1024 words, a "
                  f"multiple of 32, of {wb} bytes")
    return wb, db, W


def compress_for_kernel(x, enc: str, block_bytes: int = 512):
    """Tensor -> kernel-native uniform layout (see ``ref.py``), on x's
    device: through :func:`compress` (kernel 9 for CUDA tensors)."""
    wb, _, W = _uniform_params(enc, block_bytes)
    blocks, pad = bo.pad_to_blocks(bo.to_bytes(x), block_bytes)
    base, mask, deltas, ok = compress(blocks.view(bo.word_dtype(wb)),
                                      enc=enc, block_bytes=block_bytes)
    return dict(base=base, mask=mask, deltas=deltas, ok=ok[:, 0].bool(),
                pad=pad, shape=tuple(x.shape),
                dtype=bdi_scheme.dtype_name(x.dtype), enc=enc,
                block_bytes=block_bytes)


def decompress_words(base, mask, deltas, *, enc: str, block_bytes: int = 512):
    """base int32[nb, 1]; mask uint8[nb, W/8]; deltas uint8[nb, W*d] ->
    words int16[nb, W] (b2d1) or int32[nb, W] (b4d1, b4d2)."""
    wb, db, W = _uniform_params(enc, block_bytes)
    nb = base.shape[0]
    dev = base.device
    build.check_tensor(base, "base", dev, torch.int32, (nb, 1))
    build.check_tensor(mask, "mask", dev, torch.uint8, (nb, W // 8))
    build.check_tensor(deltas, "deltas", dev, torch.uint8, (nb, W * db))
    if dev.type == "cpu":
        blocks = bdi_ref.decompress_ref(base, mask, deltas, enc, block_bytes)
        return blocks.view(bo.word_dtype(wb))
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    out = torch.empty((nb, W), dtype=bo.word_dtype(wb), device=dev)
    if nb == 0:
        return out
    fn = build.function(UNIFORM_SOURCE, "bdi_uniform_decode",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
    rc = fn(build.ptr(base), build.ptr(mask), build.ptr(deltas),
            build.ptr(out), nb, W, wb, db, build.stream_ptr(dev))
    build.raise_on(rc, "bdi_uniform_decode")
    LAUNCHES["bdi_uniform_decode"] += 1
    return out


def decompress(base, mask, deltas, *, enc: str, block_bytes: int,
               shape: tuple, dtype: str):
    """Uniform-encoding decode -> the tensor (``dtype`` by name): the
    words of :func:`decompress_words`, folded to bytes and cut to
    ``shape``."""
    words = decompress_words(base, mask, deltas, enc=enc,
                             block_bytes=block_bytes)
    return bdi_scheme.tensor_from_bytes(words.view(torch.uint8).reshape(-1),
                                        dtype, shape)


def compress(words, *, enc: str, block_bytes: int = 512):
    """words int16[nb, W] (b2d1) or int32[nb, W] (b4d1, b4d2) -> (base
    int32[nb, 1], mask uint8[nb, W/8], deltas uint8[nb, W*d], ok
    uint8[nb, 1]): fixed-encoding encode; ``ok`` is 1 where every word of
    the block fits."""
    wb, db, W = _uniform_params(enc, block_bytes)
    nb = words.shape[0]
    dev = words.device
    build.check_tensor(words, "words", dev, bo.word_dtype(wb), (nb, W))
    if dev.type == "cpu":
        base, mask, deltas, ok = bdi_ref.compress_ref(
            words.view(torch.uint8), enc)
        return base, mask, deltas, ok.to(torch.uint8)[:, None]
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    base = torch.empty((nb, 1), dtype=torch.int32, device=dev)
    mask = torch.empty((nb, W // 8), dtype=torch.uint8, device=dev)
    deltas = torch.empty((nb, W * db), dtype=torch.uint8, device=dev)
    ok = torch.empty((nb, 1), dtype=torch.uint8, device=dev)
    if nb == 0:
        return base, mask, deltas, ok
    fn = build.function(UNIFORM_SOURCE, "bdi_uniform_encode",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
    rc = fn(build.ptr(words), build.ptr(base), build.ptr(mask),
            build.ptr(deltas), build.ptr(ok), nb, W, wb, db,
            build.stream_ptr(dev))
    build.raise_on(rc, "bdi_uniform_encode")
    LAUNCHES["bdi_uniform_encode"] += 1
    return base, mask, deltas, ok
