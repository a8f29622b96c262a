"""Per-token absmax int8 quantization of KV rows and the dense int8 cache.

Counterpart of ``repro.serving.kv_cache``: ``quantize_token`` stores each
row of ``dh`` values as int8 codes plus one f32 scale (absmax / 127, or 1
for an all-zero row); rounding is half to even, as ``jnp.round``.  It is
the paged warm tier's format and the dense engine's ``kv_mode="int8"``
cache (per attention layer):

  k8, v8 : int8[B, G, W, dh]      per-token-per-head codes
  ks, vs : f32[B, G, W]           scales

The cache is updated in place (the reference returns a new pytree).
"""
from __future__ import annotations

import torch

KV_MODES = ("bf16", "int8")


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


def init_kv_int8(batch: int, G: int, W: int, dh: int, device=None):
    return {"k8": torch.zeros((batch, G, W, dh), dtype=torch.int8,
                              device=device),
            "ks": torch.ones((batch, G, W), device=device),
            "v8": torch.zeros((batch, G, W, dh), dtype=torch.int8,
                              device=device),
            "vs": torch.ones((batch, G, W), device=device)}


def update_kv_int8(state, k_new, v_new, slot):
    """k_new/v_new: [B, G, 1, dh]; slot: int[B] write positions.  Writes
    the quantized rows into ``state`` in place and returns it."""
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    slot = slot.long()
    for (q_name, s_name), new in ((("k8", "ks"), k_new),
                                  (("v8", "vs"), v_new)):
        q8, sc = quantize_token(new[:, :, 0])
        state[q_name][rows, :, slot] = q8
        state[s_name][rows, :, slot] = sc
    return state


def kv_bytes(state) -> int:
    """Device bytes of a cache tree (compression accounting)."""
    if isinstance(state, dict):
        return sum(kv_bytes(v) for v in state.values())
    if isinstance(state, (tuple, list)):
        return sum(kv_bytes(v) for v in state)
    return state.numel() * state.element_size()
