"""Plain PyTorch oracles for the fused compressed-weight matmul.

Counterpart of ``repro.kernels.fused_matmul.ref`` for the q8 layout
(block-scaled int8, a scale per K-group of ``gk`` rows and column):

  w8 int8[K, N], scale f32[K // gk, N]

The b2d1 layout belongs to ``matmul_bdi`` (kernel 7) and is not ported.
"""
from __future__ import annotations

import torch


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
