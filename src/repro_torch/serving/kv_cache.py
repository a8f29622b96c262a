"""Per-token absmax int8 quantization of KV rows (the warm tier's format).

Counterpart of ``repro.serving.kv_cache``: ``quantize_token`` stores each
row of ``dh`` values as int8 codes plus one f32 scale (absmax / 127, or 1
for an all-zero row); rounding is half to even, as ``jnp.round``.
"""
from __future__ import annotations

import torch


def quantize_token(x):
    """[..., dh] -> (int8[..., dh], f32[...]) absmax per leading index."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q, scale):
    return q.float() * scale[..., None]
