"""Plain PyTorch oracles for the fused compressed-weight matmuls.

Counterpart of ``repro.kernels.fused_matmul.ref``.  Weight layouts
(compression blocks run along N, 256 values each):

q8   : block-scaled int8, a scale per K-group of ``gk`` rows and column --
       w8 int8[K, N], scale f32[K // gk, N]
bdi  : b2d1 on the bf16 bit patterns -- base int32[K, N/256] (a 16-bit
       pattern; the reference's u32), mask uint8[K, N/8] (32 bytes per
       256-value block, little-bit-endian: bit j of byte i is value
       8 i + j), deltas uint8[K, N]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.assist import bytesops as bo


def dequant_q8(w8, scale, gk: int):
    s = torch.repeat_interleave(scale, gk, dim=0)       # [K, N]
    return w8.float() * s


def matmul_q8_ref(x, w8, scale, gk: int, out_dtype=torch.bfloat16):
    return (x.float() @ dequant_q8(w8, scale, gk)).to(out_dtype)


def make_q8_layout(w, gk: int = 256):
    """bf16/f32[K, N] -> (w8, scale) block-scaled along K groups of gk."""
    K, N = w.shape
    assert K % gk == 0
    wf = w.float().reshape(K // gk, gk, N)
    absmax = wf.abs().amax(dim=1)                       # [K/gk, N]
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -127, 127)
    return q.reshape(K, N).to(torch.int8), scale


def _bits16(w):
    """bf16[...] -> its bit patterns as int32 in [0, 0xFFFF]."""
    return w.to(torch.bfloat16).contiguous().view(torch.int16).to(
        torch.int32) & 0xFFFF


def dequant_bdi_b2d1(base, mask, deltas):
    """-> bf16[K, N] from the b2d1 row-block layout: the sign-extended
    delta, plus the block's base where the mask bit is set, low 16 bits."""
    K, N = deltas.shape
    nb = N // 256
    d = bo.sext(deltas.to(torch.int32), 8).reshape(K, nb, 256)
    use_base = bo.unpack_bits(mask.reshape(K, nb, 32), 256)
    b = base.to(torch.int32).reshape(K, nb, 1)
    v = torch.where(use_base, b + d, d) & 0xFFFF
    w16 = torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16)
    return w16.reshape(K, N).view(torch.bfloat16)


def matmul_bdi_ref(x, base, mask, deltas, out_dtype=torch.bfloat16):
    w = dequant_bdi_b2d1(base, mask, deltas)
    return (x.float() @ w.float()).to(out_dtype)


def make_bdi_b2d1_layout(w):
    """bf16[K, N] (N % 256 == 0) -> (base, mask, deltas, ok) row-block
    b2d1, ``ok`` bool[K, N/256] where the block is held losslessly.

    As the reference: the block's first value is its base; a value within
    [-128, 128) of it (in int32, no 16-bit wrap) is stored from the base,
    else its low byte is stored from zero, which is lossless where the
    value is a signed 16-bit immediate (< 128 or >= 0xFF80)."""
    K, N = w.shape
    assert N % 256 == 0
    v = _bits16(w).reshape(K, N // 256, 256)
    base = v[..., :1]
    delta = v - base
    from_base = (delta >= -128) & (delta < 128)
    from_zero = (v < 128) | (v >= 0xFF80)
    ok = (from_base | from_zero).all(dim=-1)
    sel = torch.where(from_base, delta, v)
    mask = bo.pack_bits(from_base).reshape(K, N // 8)
    deltas = (sel & 0xFF).to(torch.uint8).reshape(K, N)
    return base[..., 0].contiguous(), mask, deltas, ok


def b2d1_weights(K: int, N: int, seed: int = 0):
    """Seeded bf16[K, N] (N % 256 == 0) that the b2d1 layout holds
    losslessly: per 256-value block a base pattern from N(0, 0.02) in
    bf16, the block's first value the base itself, the others the base
    plus a delta uniform in [-128, 127], and about one value in eight set
    to +0 (stored from zero).  Made with numpy on the host."""
    assert N % 256 == 0
    rng = np.random.default_rng(seed)
    nb = N // 256
    base = torch.from_numpy((rng.standard_normal((K, nb)) * 0.02).astype(
        np.float32)).to(torch.bfloat16)
    b = _bits16(base).numpy().astype(np.int32).reshape(K, nb, 1)
    d = rng.integers(-128, 128, (K, nb, 256), dtype=np.int8)
    d[..., 0] = 0
    zero = rng.integers(0, 8, (K, nb, 256), dtype=np.uint8) == 0
    zero[..., 0] = False
    v = np.where(zero, 0, b + d).astype(np.uint16).reshape(K, N)
    return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
