"""Model building blocks: norms, RoPE, chunked attention, GQA, MLP.

Counterpart of ``repro.models.layers``: every layer is a plain function
over a params dict, and the dtype at each step follows the reference
(bf16 activations, f32 inside norms, RoPE, softmax and the gated MLP):

* ``norm_apply`` computes in f32 and casts back to the input dtype;
* ``apply_rope`` rotates HALVES (x[:d/2], x[d/2:]), not interleaved pairs;
* ``gqa_qkv`` adds the bias in f32 and rounds the sum to bf16;
* ``mlp_apply`` applies silu to the ``wi`` branch and multiplies by the
  linear ``wg`` branch (gelu is the tanh form, as ``jax.nn.gelu``).
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.quantized import qmatmul

NEG_INF = -1e30


def _dense_init(gen: torch.Generator, shape: tuple,
                lead: tuple = ()) -> torch.Tensor:
    """bf16[*lead, *shape] of N(0, 1/fan_in).  Drawn one stacked layer at a
    time so full-width weights never hold an f32 copy of the whole stack."""
    scale = shape[0] ** -0.5
    out = torch.empty(lead + shape, dtype=torch.bfloat16, device=gen.device)
    for idx in itertools.product(*(range(n) for n in lead)):
        out[idx] = torch.randn(shape, generator=gen,
                               device=gen.device) * scale
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ArchConfig, device, lead: tuple = ()):
    p = {"scale": torch.ones(lead + (cfg.d_model,), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), device=device)
    return p


def norm_apply(cfg: ArchConfig, p, x):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, n, d]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs             # [..., S, d/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked attention core (prefill)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024):
    """Online-softmax attention over KV chunks of ``chunk`` keys, query
    positions aligned with key positions (prefill).

    q: [B, H, Sq, dh]; k/v: [B, G, Sk, dh] (GQA: H % G == 0).
    """
    B, H, Sq, dh = q.shape
    G, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    group = H // G
    qf = (q.float() * dh ** -0.5).reshape(B, G, group, Sq, dh)
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, G, group, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, G, group, Sq), device=q.device)
    acc = torch.zeros((B, G, group, Sq, dv), device=q.device)
    for c0 in range(0, Sk, chunk):
        kf = k[:, :, c0:c0 + chunk].float()
        vf = v[:, :, c0:c0 + chunk].float()
        logits = torch.einsum("bghqd,bgkd->bghqk", qf, kf)
        k_pos = c0 + torch.arange(kf.shape[2], device=q.device)
        valid = torch.ones((Sq, kf.shape[2]), dtype=torch.bool,
                           device=q.device)
        if causal:
            valid &= k_pos[None, :] <= q_pos[:, None]
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bghqk,bgkd->bghqd",
                                                    p, vf)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, Sq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()):
    D, H, G, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _dense_init(gen, (D, H * dh), lead),
         "wk": _dense_init(gen, (D, G * dh), lead),
         "wv": _dense_init(gen, (D, G * dh), lead),
         "wo": _dense_init(gen, (H * dh, D), lead)}
    if cfg.qkv_bias:
        for name, n in (("bq", H), ("bk", G), ("bv", G)):
            p[name] = torch.zeros(lead + (n * dh,), device=gen.device)
    return p


def gqa_qkv(cfg: ArchConfig, p, x, positions):
    """x: [B, S, D] -> q [B, H, S, dh], k/v [B, G, S, dh] (rope applied)."""
    B, S, _ = x.shape
    H, G, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = qmatmul(x, p, "wq")
    k = qmatmul(x, p, "wk")
    v = qmatmul(x, p, "wv")
    if cfg.qkv_bias:
        q = (q.float() + p["bq"]).to(x.dtype)
        k = (k.float() + p["bk"]).to(x.dtype)
        v = (v.float() + p["bv"]).to(x.dtype)
    q = apply_rope(q.reshape(B, S, H, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, G, dh), positions, cfg.rope_theta)
    return (q.transpose(1, 2), k.transpose(1, 2),
            v.reshape(B, S, G, dh).transpose(1, 2))


def gqa_apply(cfg: ArchConfig, p, x, *, positions=None):
    """Full-sequence forward (prefill).  Returns (out, (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = gqa_qkv(cfg, p, x, positions)
    out = chunked_attention(q, k, v, causal=cfg.causal)
    out = out.transpose(1, 2).reshape(B, S, -1)
    return qmatmul(out, p, "wo"), (k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()):
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"wi": _dense_init(gen, (D, Fd), lead)}
    if cfg.act == "silu":  # gated
        p["wg"] = _dense_init(gen, (D, Fd), lead)
    p["wo"] = _dense_init(gen, (Fd, D), lead)
    return p


def mlp_apply(cfg: ArchConfig, p, x):
    h = qmatmul(x, p, "wi")
    if cfg.act == "silu":
        g = qmatmul(x, p, "wg")
        h = F.silu(h.float()) * g.float()
    else:
        h = F.gelu(h.float(), approximate="tanh")
    return qmatmul(h.to(x.dtype), p, "wo")
