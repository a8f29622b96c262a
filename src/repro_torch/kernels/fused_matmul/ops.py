"""The compressed-weight matmuls, each behind one wrapper.

Counterpart of ``repro.kernels.fused_matmul.ops``.  :func:`matmul_q8`,
y = x @ (w8 * scale), has two forms:

* the CUDA kernel (``csrc/matmul_q8.cu``, kernel 6 of the port's table,
  replacing ``repro.kernels.fused_matmul.fused_matmul.matmul_q8``),
  launched for CUDA tensors on the current stream -- a failed build or
  launch raises;
* the plain PyTorch form :func:`matmul_q8_plain`, used only for CPU
  tensors and as the kernel's oracle on the card.

Both apply the scale once per (K-group, column) to that group's f32
partial sum and round the sum to bf16 once.  ``bf16_scale=True`` first
rounds each scale to bf16, as the reference model's q8 consumer does
(``models.quantized.qmatmul``).  Any M is taken (the TPU
kernel asks for ``M % 128 == 0``).

:func:`matmul_bdi`, y = x @ W with W rebuilt from the lossless b2d1
layout (``ref.make_bdi_b2d1_layout``), likewise: the CUDA kernel
``csrc/matmul_bdi.cu`` (kernel 7, replacing
``repro.kernels.fused_matmul.fused_matmul.matmul_bdi``) for CUDA tensors,
:func:`matmul_bdi_plain` for CPU tensors and as its oracle.  It takes any
M; N must be a multiple of 256 (whole b2d1 blocks), K of the kernel's K
step ``BK``.

``LAUNCHES`` counts kernel launches (plain calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_matmul.ref import matmul_bdi_ref

KERNEL_SOURCE = "fused_matmul/matmul_q8"
BDI_SOURCE = "fused_matmul/matmul_bdi"
LAUNCHES = {"matmul_q8": 0, "matmul_bdi": 0}
BN, BK = 128, 32            # the kernel's output columns per block, K step
#: split K until the grid holds about this many blocks per SM, keeping at
#: least MIN_SPLIT_TILES K steps in each split.  Chosen for decode (M = the
#: slots); chip_smoke.py times one layer at 1, 2, 4 and 8 for every M
BLOCKS_PER_SM = 4
MIN_SPLIT_TILES = 8

_SMS: dict = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def matmul_q8_plain(x, w8, scale, gk: int, bf16_scale: bool = False):
    """Plain form of :func:`matmul_q8` (per-group f32 dots, then scale)."""
    if bf16_scale:
        scale = scale.to(torch.bfloat16).float()
    M, K = x.shape
    N = w8.shape[1]
    xg = x.float().reshape(M, K // gk, gk)
    wg = w8.float().reshape(K // gk, gk, N)
    part = torch.einsum("mgk,gkn->mgn", xg, wg)          # [M, K/gk, N]
    return (part * scale[None]).sum(dim=1).to(torch.bfloat16)


def _split_plan(M: int, N: int, K: int, device) -> tuple:
    """(m_tiles, K tiles per split, splits) for one call."""
    m_tiles = 1 if M <= 16 else 4
    tiles = -(-M // (16 * m_tiles)) * -(-N // BN)
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    kt = K // BK
    want = -(-BLOCKS_PER_SM * _SMS[device] // tiles)
    splits = max(1, min(want, kt // MIN_SPLIT_TILES))
    kt_per = -(-kt // splits)
    return m_tiles, kt_per, -(-kt // kt_per)


def matmul_q8(x, w8, scale, *, gk: int = 256, bf16_scale: bool = False):
    """y = x @ dequant(w8, scale).  x: bf16[M, K]; w8: int8[K, N]; scale:
    f32[K / gk, N] (rounded to bf16 first with ``bf16_scale``) ->
    bf16[M, N]."""
    M, K = x.shape
    N = w8.shape[1]
    dev = x.device
    build.require(gk > 0 and K % gk == 0, f"K={K} is not a multiple of "
                  f"gk={gk}")
    build.check_tensor(x, "x", dev, torch.bfloat16, (M, K))
    build.check_tensor(w8, "w8", dev, torch.int8, (K, N))
    build.check_tensor(scale, "scale", dev, torch.float32, (K // gk, N))
    if dev.type == "cpu":
        return matmul_q8_plain(x, w8, scale, gk, bf16_scale)
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    build.require(K % BK == 0 and gk % BK == 0 and N % 16 == 0,
                  f"K={K} and gk={gk} must be multiples of {BK}, N={N} "
                  f"of 16")
    for name, t in (("x", x), ("w8", w8)):
        build.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte "
                      f"aligned")
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return y
    m_tiles, kt_per, splits = _split_plan(M, N, K, dev)
    work = torch.empty((splits * M * N if splits > 1 else 1,),
                       dtype=torch.float32, device=dev)
    counters = build.tile_counters(
        "matmul_q8", dev, -(-M // (16 * m_tiles)) * -(-N // BN))
    fn = build.function(KERNEL_SOURCE, "matmul_q8",
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p])
    ptr = build.ptr
    rc = fn(ptr(x), ptr(w8), ptr(scale), ptr(y), ptr(work), ptr(counters),
            M, N, K, gk, m_tiles, kt_per, int(bf16_scale),
            build.stream_ptr(dev))
    build.raise_on(rc, "matmul_q8")
    LAUNCHES["matmul_q8"] += 1
    return y


#: plain form of :func:`matmul_bdi`: rebuild W, one f32 product
matmul_bdi_plain = matmul_bdi_ref


def matmul_bdi(x, base, mask, deltas):
    """y = x @ dequant_bdi_b2d1(base, mask, deltas).  x: bf16[M, K]; base:
    int32[K, N/256]; mask: uint8[K, N/8]; deltas: uint8[K, N] ->
    bf16[M, N], f32 accumulation."""
    M, K = x.shape
    N = deltas.shape[1]
    dev = x.device
    build.require(N % 256 == 0, f"N={N} is not a multiple of 256")
    build.check_tensor(x, "x", dev, torch.bfloat16, (M, K))
    build.check_tensor(base, "base", dev, torch.int32, (K, N // 256))
    build.check_tensor(mask, "mask", dev, torch.uint8, (K, N // 8))
    build.check_tensor(deltas, "deltas", dev, torch.uint8, (K, N))
    if dev.type == "cpu":
        return matmul_bdi_plain(x, base, mask, deltas)
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    build.require(K % BK == 0, f"K={K} must be a multiple of {BK}")
    for name, t in (("x", x), ("mask", mask), ("deltas", deltas)):
        build.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte "
                      f"aligned")
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return y
    m_tiles, kt_per, splits = _split_plan(M, N, K, dev)
    work = torch.empty((splits * M * N if splits > 1 else 1,),
                       dtype=torch.float32, device=dev)
    counters = build.tile_counters(
        "matmul_bdi", dev, -(-M // (16 * m_tiles)) * (N // BN))
    fn = build.function(BDI_SOURCE, "matmul_bdi",
                        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
    ptr = build.ptr
    rc = fn(ptr(x), ptr(base), ptr(mask), ptr(deltas), ptr(y), ptr(work),
            ptr(counters), M, N, K, m_tiles, kt_per, build.stream_ptr(dev))
    build.raise_on(rc, "matmul_bdi")
    LAUNCHES["matmul_bdi"] += 1
    return y
