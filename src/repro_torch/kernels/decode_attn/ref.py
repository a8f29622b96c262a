"""Plain PyTorch oracle for dense compressed-KV flash-decode attention.

Counterpart of ``repro.kernels.decode_attn.ref``.  Decode step: one new
query token per sequence attends over an S-long KV cache, stored per-token
block-scaled int8 or as bf16:

  k8, v8 : int8[B, G, S, D]
  ks, vs : f32[B, G, S]      per-token absmax scales

GQA: H query heads share G KV heads (group = H // G).  These are the
reference's formulas as they are (an -inf mask and a plain softmax), so a
row whose positions are all masked, or NaN beyond the length, gives NaN
here as it does there; the kernel's plain form
(``dense.decode_attn_plain``) is the NaN-safe one.
"""
from __future__ import annotations

import math

import torch

# the reference's per-token quantizer is the KV cache's: one copy, in
# serving.kv_cache
from repro_torch.serving.kv_cache import dequantize as dequantize_kv  # noqa: F401
from repro_torch.serving.kv_cache import quantize_token as quantize_kv  # noqa: F401


def _softmax_attend(q, k, v, lengths, out_dtype):
    B, H, D = q.shape
    G, S = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, G, H // G, D)
    logits = torch.einsum("bghd,bgsd->bghs", qf, k) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(mask[:, None, None, :], logits, -math.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bghs,bgsd->bghd", p, v)
    return out.reshape(B, H, D).to(out_dtype)


def decode_attn_ref(q, k8, ks, v8, vs, lengths, out_dtype=torch.bfloat16):
    """q: [B, H, D]; k8/v8: int8[B, G, S, D]; ks/vs: f32[B, G, S];
    lengths: int32[B] -> out [B, H, D]."""
    return _softmax_attend(q, dequantize_kv(k8, ks), dequantize_kv(v8, vs),
                           lengths, out_dtype)


def decode_attn_raw_ref(q, k, v, lengths, out_dtype=torch.bfloat16):
    """Uncompressed baseline (same math, bf16 KV)."""
    return _softmax_attend(q, k.float(), v.float(), lengths, out_dtype)
