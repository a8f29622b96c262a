"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; the four assigned
input-shape sets are ``ShapeConfig``s.  ``reduced()`` derives the small
same-family config used by CPU smoke tests (full configs are only ever
lowered from ShapeDtypeStructs in the dry-run).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: The one end-of-sequence token id every layer defaults to.  ServeConfig
#: and the engine import THIS constant -- never write a literal eos
#: default, or direct construction and ServeConfig stop on different tokens.
DEFAULT_EOS_ID = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = no q compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 64
    n_shared: int = 2
    top_k: int = 6
    d_expert: int = 1408            # per-expert FFN hidden
    # routed experts replace the dense FFN on every layer except the first
    first_dense: int = 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64              # mamba2 head dim


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64            # rank of the data-dependent decay LoRA


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    # layer pattern: the repeating unit scanned over (superblocks).
    # kinds: attn | attn_local | mamba2 | rwkv6 | shared_attn
    block_pattern: tuple = ("attn",)
    window: int = 0                 # local-attention window
    causal: bool = True
    qkv_bias: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # silu | gelu
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    frontend: str = "none"          # none | audio | vision (stub embeddings)
    # how many image-patch embeddings prepend the text (vlm stub)
    n_patches: int = 0
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // max(self.n_heads, 1)

    @property
    def n_blocks(self) -> int:
        """Number of scanned superblocks (+ tail handled separately)."""
        return self.n_layers // len(self.block_pattern)

    @property
    def tail_layers(self) -> int:
        return self.n_layers % len(self.block_pattern)

    @property
    def attention_free(self) -> bool:
        return all(k in ("mamba2", "rwkv6") for k in self.block_pattern)

    @property
    def decoder(self) -> bool:
        return self.causal

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D                              # embed
        if not self.tie_embeddings:
            total += V * D                         # unembed
        per_kind = {}
        for kind in set(self.block_pattern):
            per_kind[kind] = self._layer_params(kind)
        n_per_pattern = {}
        for kind in self.block_pattern:
            n_per_pattern[kind] = n_per_pattern.get(kind, 0) + 1
        blocks = self.n_blocks
        for kind, cnt in n_per_pattern.items():
            if kind == "shared_attn":
                total += per_kind[kind]            # weights shared once
            else:
                total += per_kind[kind] * cnt * blocks
        for kind in self.block_pattern[:self.tail_layers]:
            if kind != "shared_attn":
                total += per_kind[kind]
        # MoE first_dense layers use a dense FFN instead of the MoE FFN
        if self.moe is not None and self.moe.first_dense:
            dense_ffn = 3 * D * F if self.act == "silu" else 2 * D * F
            total -= self.moe.first_dense * (self._ffn_params() - dense_ffn)
        return total

    def _layer_params(self, kind: str) -> int:
        D, F = self.d_model, self.d_ff
        H, G, dh = self.n_heads, self.n_kv_heads, self.head_dim
        if kind in ("attn", "attn_local", "shared_attn"):
            if self.mla is not None:
                m = self.mla
                qd = (m.nope_head_dim + m.rope_head_dim)
                attn = (D * m.kv_lora_rank + D * m.rope_head_dim   # down kv + k_rope
                        + m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
                        + (D * H * qd if not m.q_lora_rank else
                           D * m.q_lora_rank + m.q_lora_rank * H * qd)
                        + H * m.v_head_dim * D)
            else:
                attn = D * H * dh + 2 * D * G * dh + H * dh * D
            ffn = self._ffn_params()
            return attn + ffn
        if kind == "mamba2":
            s = self.ssm
            d_in = s.expand * D
            nheads = d_in // s.head_dim
            return (D * (2 * d_in + 2 * s.d_state + nheads)   # in_proj(z,x)+B,C,dt
                    + d_in * s.d_conv + d_in * D)             # conv + out_proj
        if kind == "rwkv6":
            r = self.rwkv
            tm = 5 * D * D                          # r,k,v,g,o (square)
            tm += 2 * D * r.decay_lora              # decay lora
            cm = 2 * D * self.d_ff + D * D          # channel mix k, v + receptance
            return tm + cm
        raise ValueError(kind)

    def _ffn_params(self) -> int:
        D, F = self.d_model, self.d_ff
        if self.moe is not None:
            m = self.moe
            routed = m.n_routed * 3 * D * m.d_expert
            shared = m.n_shared * 3 * D * m.d_expert
            router = D * m.n_routed
            return routed + shared + router        # (dense-first handled approx.)
        return 3 * D * F if self.act == "silu" else 2 * D * F

    def active_param_count(self) -> int:
        """Activated params per token (MoE: shared + top_k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        D = self.d_model
        per_layer_active = (m.n_shared + m.top_k) * 3 * D * m.d_expert + D * m.n_routed
        per_layer_total = (m.n_shared + m.n_routed) * 3 * D * m.d_expert + D * m.n_routed
        return self.param_count() - self.n_layers * (per_layer_total - per_layer_active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def reduced(cfg: ArchConfig, n_layers: int | None = None) -> ArchConfig:
    """Small same-family config for CPU smoke tests."""
    pat = len(cfg.block_pattern)
    nl = n_layers or max(pat, 2 if pat == 1 else pat)
    updates = dict(
        n_layers=nl,
        d_model=128,
        n_heads=max(2, min(4, cfg.n_heads or 2)),
        n_kv_heads=max(1, min(2, cfg.n_kv_heads or 1)),
        d_head=0,
        d_ff=256,
        vocab_size=512,
        n_patches=8 if cfg.frontend == "vision" else 0,
    )
    if cfg.mla is not None:
        updates["mla"] = MLAConfig(kv_lora_rank=32, rope_head_dim=16,
                                   nope_head_dim=32, v_head_dim=32,
                                   q_lora_rank=0)
        updates["d_head"] = 0
    if cfg.moe is not None:
        updates["moe"] = MoEConfig(n_routed=8, n_shared=1, top_k=2,
                                   d_expert=64, first_dense=cfg.moe.first_dense)
    if cfg.ssm is not None:
        updates["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32)
    if cfg.rwkv is not None:
        updates["rwkv"] = RWKVConfig(head_dim=32, decay_lora=16)
    return dataclasses.replace(cfg, **updates)


SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")
