"""hubert-xlarge [audio]: 48L d=1280 16H d_ff=5120 vocab=504 -- encoder-only
transformer backbone (w2v2-style); the audio frontend is a STUB: inputs are
precomputed frame embeddings [B, S, d_model]. [arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    block_pattern=("attn",),
    causal=False,              # encoder-only: bidirectional, no decode step
    norm="layernorm",
    act="gelu",
    frontend="audio",
)
