"""Paged flash-decode: KV gathered through a block table.

Counterpart of ``repro.kernels.decode_attn.paged``.  Each function has two
forms behind one wrapper:

* the CUDA kernel (``csrc/paged_decode_attn.cu``, built by
  ``repro_torch.kernels.build``), launched for CUDA tensors on the current
  stream -- a failed build or launch raises;
* a plain PyTorch form beside it (``*_plain``: gather the table into a
  dense cache, then a masked softmax), used only for CPU tensors and as
  the kernel's oracle on the card.

Both compute the reference step: logits scaled by D^-0.5 after the dot,
positions ``>= len`` (and ``< len - window``) masked, invalid V rows
selected to 0 (trash pages may hold NaN), denominator ``max(l, 1e-30)`` so
a ``len == 0`` row gives 0, f32 accumulation, output in q's dtype.  Table
entries outside the pool clamp into it (a JAX gather clamps too).

``LAUNCHES`` counts kernel launches per wrapper (plain calls do not
count), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
KERNEL_SOURCE = "decode_attn/paged_decode_attn"
LAUNCHES = {"paged_decode_attn": 0, "paged_decode_attn_tiered": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain forms -------------------------------------------------------------

def gather_pool(pool, block_table):
    """pool [P, G, ps, D] + table [B, NP] -> dense [B, G, NP*ps, D]."""
    B, NP = block_table.shape
    _, G, ps, D = pool.shape
    g = pool[block_table.long()]                # [B, NP, G, ps, D]
    return g.transpose(1, 2).reshape(B, G, NP * ps, D)


def gather_scales(scales, block_table):
    """scales [P, G, ps] + table [B, NP] -> [B, G, NP*ps]."""
    B, NP = block_table.shape
    _, G, ps = scales.shape
    g = scales[block_table.long()]              # [B, NP, G, ps]
    return g.transpose(1, 2).reshape(B, G, NP * ps)


def _gathered(pool, scales, block_table):
    """Dense f32 cache of the pages a table names (int8 dequantized)."""
    x = gather_pool(pool, block_table).float()
    if pool.dtype == torch.int8:
        x = x * gather_scales(scales, block_table)[..., None]
    return x


def masked_attn_plain(q, k, v, lengths, window: int = 0):
    """q [B, H, D]; dense f32 k/v [B, G, S, D]; lengths int32[B] -> [B, H, D]
    in q's dtype.  The reference step in one (non-online) softmax."""
    B, H, D = q.shape
    G, S = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, G, H // G, D)
    logits = torch.einsum("bghd,bgsd->bghs", qf, k) * (D ** -0.5)
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window:
        valid &= pos >= lengths[:, None] - window
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid[:, None, None, :], torch.exp(logits - m), 0.0)
    vf = torch.where(valid[:, None, :, None], v, 0.0)
    out = torch.einsum("bghs,bgsd->bghd", p, vf)
    out = out / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attn_plain(q, k_pool, ks_pool, v_pool, vs_pool, block_table,
                            lengths, *, window: int = 0):
    """Plain form of :func:`paged_decode_attn`."""
    bt = block_table.clamp(0, k_pool.shape[0] - 1)
    return masked_attn_plain(q, _gathered(k_pool, ks_pool, bt),
                             _gathered(v_pool, vs_pool, bt), lengths, window)


def paged_decode_attn_tiered_plain(q, kh_pool, vh_pool, k8_pool, ks_pool,
                                   v8_pool, vs_pool, block_table, lengths, *,
                                   window: int = 0):
    """Plain form of :func:`paged_decode_attn_tiered`."""
    is_warm = (block_table < 0)[:, None, :, None].repeat_interleave(
        kh_pool.shape[2], dim=2)                # [B, 1, NP*ps, 1]
    hot_bt = block_table.clamp(0, kh_pool.shape[0] - 1)
    warm_bt = (-block_table).clamp(0, k8_pool.shape[0] - 1)

    def dense(hot, q8, sc):
        return torch.where(is_warm, _gathered(q8, sc, warm_bt),
                           _gathered(hot, None, hot_bt))

    return masked_attn_plain(q, dense(kh_pool, k8_pool, ks_pool),
                             dense(vh_pool, v8_pool, vs_pool), lengths,
                             window)


# -- kernel wrappers ---------------------------------------------------------

def _check_common(q, block_table, lengths, G: int, ps: int, D: int):
    build.require(q.dtype in (torch.bfloat16, torch.float32),
                  f"q must be bf16 or f32, got {q.dtype}")
    build.require(q.dim() == 3 and q.shape[2] == D,
                  f"q must be [B, H, {D}], got {tuple(q.shape)}")
    B, H = q.shape[0], q.shape[1]
    build.require(H % G == 0 and H // G <= 16,
                  f"H={H} must be a multiple of G={G} with H/G <= 16")
    build.require(D <= 256, f"head dim {D} > 256")
    smem = 4 * ((H // G) * D + 2 * ps * D + (H // G) * ps + 3 * (H // G))
    build.require(smem <= 48 * 1024,
                  f"tile needs {smem} B of shared memory")
    build.require(block_table.dtype == torch.int32
                  and block_table.dim() == 2 and block_table.shape[0] == B,
                  f"block_table must be int32[{B}, n_pages]")
    build.require(lengths.dtype == torch.int32
                  and tuple(lengths.shape) == (B,),
                  f"lengths must be int32[{B}]")


#: C signatures: (pointer arguments, int arguments), then scale and stream
_SIGNATURES = {"paged_decode_attn": (8, 10),
               "paged_decode_attn_tiered": (10, 10)}


def _lib(fn_name: str):
    n_ptr, n_int = _SIGNATURES[fn_name]
    return build.function(KERNEL_SOURCE, fn_name,
                          [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                          + [ctypes.c_float, ctypes.c_void_p])


def paged_decode_attn(q, k_pool, ks_pool, v_pool, vs_pool, block_table,
                      lengths, *, window: int = 0):
    """q: [B, H, D]; pools: int8/bf16/f32[P, G, ps, D] (+ f32[P, G, ps]
    scales, read only for int8); block_table: int32[B, n_pages] pool slots;
    lengths: int32[B] -> [B, H, D] in q's dtype.  ``window > 0`` masks to
    the last ``window`` positions.  Replaces the TPU kernel
    ``repro.kernels.decode_attn.paged.paged_decode_attn``."""
    P, G, ps, D = k_pool.shape
    _check_common(q, block_table, lengths, G, ps, D)
    build.require(k_pool.dtype in _DTYPE_CODE, f"pool dtype {k_pool.dtype}")
    dev = q.device
    build.check_tensor(q, "q", dev, q.dtype, q.shape)
    build.check_tensor(k_pool, "k_pool", dev, k_pool.dtype, (P, G, ps, D))
    build.check_tensor(v_pool, "v_pool", dev, k_pool.dtype, (P, G, ps, D))
    if k_pool.dtype == torch.int8:
        build.check_tensor(ks_pool, "ks_pool", dev, torch.float32,
                           (P, G, ps))
        build.check_tensor(vs_pool, "vs_pool", dev, torch.float32,
                           (P, G, ps))
    build.check_tensor(block_table, "block_table", dev, torch.int32,
                       block_table.shape)
    build.check_tensor(lengths, "lengths", dev, torch.int32, lengths.shape)
    if dev.type == "cpu":
        return paged_decode_attn_plain(q, k_pool, ks_pool, v_pool, vs_pool,
                                       block_table, lengths, window=window)
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    B, H, _ = q.shape
    out = torch.empty_like(q)
    scales = (ks_pool, vs_pool) if k_pool.dtype == torch.int8 \
        else (k_pool, v_pool)           # not read: any valid pointer
    fn = _lib("paged_decode_attn")
    ptr = build.ptr
    rc = fn(ptr(q), ptr(k_pool), ptr(scales[0]), ptr(v_pool), ptr(scales[1]),
            ptr(block_table), ptr(lengths), ptr(out),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], B, H, G, P, ps,
            D, block_table.shape[1], int(window), D ** -0.5,
            build.stream_ptr(dev))
    build.raise_on(rc, "paged_decode_attn")
    LAUNCHES["paged_decode_attn"] += 1
    return out


def paged_decode_attn_tiered(q, kh_pool, vh_pool, k8_pool, ks_pool, v8_pool,
                             vs_pool, block_table, lengths, *,
                             window: int = 0):
    """Mixed hot/warm paged flash-decode through an ENCODED block table.

    q: [B, H, D]; hot pools bf16[P_hot, G, ps, D]; warm pools
    int8[P_warm, G, ps, D] + f32[P_warm, G, ps] scales; block_table:
    int32[B, n_pages] encoded locations (>0 hot, <0 warm, 0 trash);
    lengths: int32[B] -> [B, H, D] in q's dtype.  Replaces the TPU kernel
    ``repro.kernels.decode_attn.paged.paged_decode_attn_tiered``."""
    Ph, G, ps, D = kh_pool.shape
    Pw = k8_pool.shape[0]
    _check_common(q, block_table, lengths, G, ps, D)
    dev = q.device
    build.check_tensor(q, "q", dev, q.dtype, q.shape)
    for name, t in (("kh_pool", kh_pool), ("vh_pool", vh_pool)):
        build.check_tensor(t, name, dev, torch.bfloat16, (Ph, G, ps, D))
    for name, t in (("k8_pool", k8_pool), ("v8_pool", v8_pool)):
        build.check_tensor(t, name, dev, torch.int8, (Pw, G, ps, D))
    for name, t in (("ks_pool", ks_pool), ("vs_pool", vs_pool)):
        build.check_tensor(t, name, dev, torch.float32, (Pw, G, ps))
    build.check_tensor(block_table, "block_table", dev, torch.int32,
                       block_table.shape)
    build.check_tensor(lengths, "lengths", dev, torch.int32, lengths.shape)
    if dev.type == "cpu":
        return paged_decode_attn_tiered_plain(
            q, kh_pool, vh_pool, k8_pool, ks_pool, v8_pool, vs_pool,
            block_table, lengths, window=window)
    build.require(dev.type == "cuda", f"no kernel for device {dev}")
    B, H, _ = q.shape
    out = torch.empty_like(q)
    fn = _lib("paged_decode_attn_tiered")
    ptr = build.ptr
    rc = fn(ptr(q), ptr(kh_pool), ptr(vh_pool), ptr(k8_pool), ptr(ks_pool),
            ptr(v8_pool), ptr(vs_pool), ptr(block_table), ptr(lengths),
            ptr(out), _DTYPE_CODE[q.dtype], B, H, G, Ph, Pw,
            ps, D, block_table.shape[1], int(window), D ** -0.5,
            build.stream_ptr(dev))
    build.raise_on(rc, "paged_decode_attn_tiered")
    LAUNCHES["paged_decode_attn_tiered"] += 1
    return out
