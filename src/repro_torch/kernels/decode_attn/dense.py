"""Dense flash-decode over a [B, G, S, D] KV cache, int8 or bf16.

Counterpart of ``repro.kernels.decode_attn.decode_attn``.  Two forms
behind :func:`decode_attn`:

* the CUDA kernel (``csrc/decode_attn.cu``, built by
  ``repro_torch.kernels.build``), launched for CUDA tensors on the current
  stream -- a failed build or launch raises;
* the plain PyTorch form :func:`decode_attn_plain`, used only for CPU
  tensors and as the kernel's oracle on the card.

Both compute the TPU kernel's step: logits scaled by D^-0.5 after the dot
(int8 K dequantized by its per-token scale), positions ``>= lengths[b]``
masked, invalid V rows selected to 0 (rows beyond the length may hold
NaN), denominator ``max(l, 1e-30)`` so a ``len == 0`` row gives 0, f32
accumulation, bf16 output.  A length beyond S counts as S.

``LAUNCHES`` counts kernel launches (plain calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attn.paged import masked_attn_plain
from repro_torch.serving.kv_cache import dequantize

KERNEL_SOURCE = "decode_attn/decode_attn"
LAUNCHES = {"decode_attn": 0}
#: KV positions per block: a (b, g) row of S positions is split over
#: ceil(S / CHUNK) blocks whose partial softmaxes the last block merges
CHUNK = 64
MAX_GROUP = 8


def reset_launches():
    LAUNCHES["decode_attn"] = 0


def decode_attn_plain(q, k, ks, v, vs, lengths):
    """Plain form of :func:`decode_attn` (one non-online softmax)."""
    if k.dtype == torch.int8:
        kf, vf = dequantize(k, ks), dequantize(v, vs)
    else:
        kf, vf = k.float(), v.float()
    return masked_attn_plain(q, kf, vf, lengths)


def decode_attn(q, k, ks, v, vs, lengths):
    """q: bf16[B, H, D]; k/v: int8 or bf16 [B, G, S, D]; ks/vs: f32[B, G, S]
    (read only for int8, may be None otherwise); lengths: int32[B] ->
    bf16[B, H, D].  Replaces the TPU kernel
    ``repro.kernels.decode_attn.decode_attn.decode_attn``."""
    B, H, D = q.shape
    _, G, S, _ = k.shape
    dev = q.device
    build.require(k.dtype in (torch.int8, torch.bfloat16),
                  f"k must be int8 or bf16, got {k.dtype}")
    build.check_tensor(q, "q", dev, torch.bfloat16, (B, H, D))
    build.check_tensor(k, "k", dev, k.dtype, (B, G, S, D))
    build.check_tensor(v, "v", dev, k.dtype, (B, G, S, D))
    quantized = k.dtype == torch.int8
    if quantized:
        build.check_tensor(ks, "ks", dev, torch.float32, (B, G, S))
        build.check_tensor(vs, "vs", dev, torch.float32, (B, G, S))
    build.check_tensor(lengths, "lengths", dev, torch.int32, (B,))
    if dev.type == "cpu":
        return decode_attn_plain(q, k, ks, v, vs, lengths)
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    build.require(H % G == 0 and H // G <= MAX_GROUP,
                  f"H={H} must be a multiple of G={G} with H/G <= "
                  f"{MAX_GROUP}")
    build.require(D % 32 == 0 and D <= 128, f"head dim {D} must be a "
                  f"multiple of 32, at most 128")
    for name, t in (("k", k), ("v", v)):
        build.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte "
                      f"aligned")
    out = torch.empty_like(q)
    n_split = -(-S // CHUNK)
    group = H // G
    # per split: acc [group, D], then m and l [group]
    work = torch.empty((B * G * n_split * group * (D + 2),),
                       dtype=torch.float32, device=dev)
    counters = build.tile_counters("decode_attn", dev, B * G)
    if not quantized:
        ks = vs = lengths               # not read: any valid pointer
    fn = build.function(KERNEL_SOURCE, "decode_attn",
                        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                        + [ctypes.c_float, ctypes.c_void_p])
    ptr = build.ptr
    rc = fn(ptr(q), ptr(k), ptr(ks), ptr(v), ptr(vs), ptr(lengths), ptr(out),
            ptr(work), ptr(counters), int(quantized), B, H, G, S, D, CHUNK,
            D ** -0.5, build.stream_ptr(dev))
    build.raise_on(rc, "decode_attn")
    LAUNCHES["decode_attn"] += 1
    return out
