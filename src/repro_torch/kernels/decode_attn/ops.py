"""Dense decode-attention ops and the paged attention-backend registry.

Counterpart of ``repro.kernels.decode_attn.ops``.  The dense ops
(``decode_attn_q8`` over an int8 cache, ``decode_attn_raw`` over a bf16
one) are kernel 3 (``dense.decode_attn``); the dense engine's decode
attention goes through them.  The registry keeps the reference's backend
names so ``--attn-backend`` values and test matrices carry over.  Uniform
signature:

  backend(q, pools_j, bt, lengths, *, window=0, has_warm=True) -> out

  q        bf16[B, H, dh]        this tick's queries (post-rope)
  pools_j  one layer's tier pools: kh/vh bf16[1+hot, G, ps, dh],
           k8/v8 int8[1+warm, G, ps, dh], ks/vs f32[1+warm, G, ps]
  bt       int32[B, maxp]        ENCODED locations (>0 hot slot, <0 warm
                                 slot -loc, 0 trash)
  lengths  int32[B]              valid tokens INCLUDING this tick's write
  window   >0 masks attention to the last ``window`` positions
  has_warm False promises bt >= 0, so the int8 tier is skipped

Backends:
  gather       plain PyTorch: gather both tiers into a dense f32 cache, then
               :func:`masked_decode_attn`
  pallas       the paged CUDA kernel (``paged.paged_decode_attn``, the
               counterpart of the TPU ``pallas`` backend): warm pages are
               first dequantized into an f32 pool appended after the hot
               slots -- the materialization ``pallas_int8`` avoids
  pallas_int8  the tiered CUDA kernel (``paged.paged_decode_attn_tiered``):
               hot tiles read bf16, warm tiles read int8 and dequantize in
               shared memory right after the load (fused decompression)

The kernel backends run their plain forms for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn import dense
from repro_torch.kernels.decode_attn import paged as pg

NEG_INF = -1e30


def decode_attn_q8(q, k8, ks, v8, vs, lengths):
    """Flash-decode over int8 KV (the CABA compressed-KV site)."""
    return dense.decode_attn(q, k8, ks, v8, vs, lengths)


def decode_attn_raw(q, k, v, lengths):
    """Uncompressed-KV baseline through the same kernel."""
    return dense.decode_attn(q, k, None, v, None, lengths)


ATTN_BACKENDS: dict = {}


def register_attn_backend(name: str):
    def deco(fn):
        ATTN_BACKENDS[name] = fn
        return fn
    return deco


def get_attn_backend(name: str):
    try:
        return ATTN_BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown attention backend {name!r}; "
                       f"registered: {attn_backend_names()}") from None


def attn_backend_names() -> tuple:
    return tuple(sorted(ATTN_BACKENDS))


def _pool_valid(bt, lengths, ps: int, window: int):
    """bool[B, maxp*ps] position validity for a paged request."""
    pos = torch.arange(bt.shape[1] * ps, device=bt.device)[None, :]
    valid = pos < lengths[:, None]
    if window:
        valid &= pos >= lengths[:, None] - window
    return valid


def masked_decode_attn(q, k, v, valid):
    """q: [B,H,dh]; k/v: [B,G,S,dh] (any float dtype); valid: bool[B,S]
    -> [B,H,dh] in q's dtype.

    Plain (non-online) f32 softmax with the query scaled BEFORE the dot,
    as the reference decode attention.  Invalid V rows are selected to 0
    (paged gathers read the trash slot, which may hold NaN)."""
    B, H, dh = q.shape
    G = k.shape[1]
    qf = (q.float() * dh ** -0.5).reshape(B, G, H // G, dh)
    logits = torch.einsum("bghd,bgsd->bghs", qf, k.float())
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    pr = torch.exp(logits - m)
    vf = torch.where(valid[:, None, :, None], v.float(), 0.0)
    out = torch.einsum("bghs,bgsd->bghd", pr, vf)
    out = out / pr.sum(dim=-1)[..., None]
    return out.reshape(B, H, v.shape[-1]).to(q.dtype)


@register_attn_backend("gather")
def attn_backend_gather(q, pools_j, bt, lengths, *, window: int = 0,
                        has_warm: bool = True):
    """Plain baseline: gather both tiers into a dense f32 cache, then mask."""
    kh = pools_j["kh"]
    B = q.shape[0]
    G, ps = kh.shape[1], kh.shape[2]
    maxp = bt.shape[1]
    is_warm = bt < 0
    hot_idx = torch.where(bt > 0, bt, 0).long()
    warm_idx = torch.where(is_warm, -bt, 0).long()
    sel = is_warm[:, :, None, None, None]

    def gathered(hot_pool, q8_pool, sc_pool):
        x = hot_pool[hot_idx].float()               # [B, maxp, G, ps, dh]
        if has_warm:
            warm = q8_pool[warm_idx].float() * sc_pool[warm_idx][..., None]
            x = torch.where(sel, warm, x)
        return x.transpose(1, 2).reshape(B, G, maxp * ps, hot_pool.shape[-1])

    k = gathered(kh, pools_j["k8"], pools_j["ks"])
    v = gathered(pools_j["vh"], pools_j["v8"], pools_j["vs"])
    return masked_decode_attn(q, k, v, _pool_valid(bt, lengths, ps, window))


@register_attn_backend("pallas")
def attn_backend_pallas(q, pools_j, bt, lengths, *, window: int = 0,
                        has_warm: bool = True):
    """The paged CUDA kernel over one pool.  With warm pages, they are
    first dequantized into an f32 pool appended after the hot slots (f32
    keeps warm numerics identical to ``gather``); hot-only tables feed the
    bf16 pools straight through."""
    if has_warm:
        kw = pools_j["k8"].float() * pools_j["ks"][..., None]
        vw = pools_j["v8"].float() * pools_j["vs"][..., None]
        k_pool = torch.cat([pools_j["kh"].float(), kw], dim=0)
        v_pool = torch.cat([pools_j["vh"].float(), vw], dim=0)
        n_hot = pools_j["kh"].shape[0]
        bt = torch.where(bt < 0, n_hot - bt, bt)   # warm slot w -> n_hot+w
    else:
        k_pool, v_pool = pools_j["kh"], pools_j["vh"]
    return pg.paged_decode_attn(q, k_pool, None, v_pool, None, bt, lengths,
                                window=window)


@register_attn_backend("pallas_int8")
def attn_backend_pallas_int8(q, pools_j, bt, lengths, *, window: int = 0,
                             has_warm: bool = True):
    """The tiered CUDA kernel: hot tiles read bf16, warm tiles read int8
    and dequantize right after the load (fused decompression)."""
    del has_warm                       # the sign branch handles hot-only
    return pg.paged_decode_attn_tiered(
        q, pools_j["kh"], pools_j["vh"], pools_j["k8"], pools_j["ks"],
        pools_j["v8"], pools_j["vs"], bt, lengths, window=window)
