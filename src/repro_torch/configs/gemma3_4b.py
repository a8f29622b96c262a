"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144 --
5:1 local:global attention, 128k context. [hf:google/gemma-3-*; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,               # 5 superblocks of (5 local + 1 global) + 4 local tail
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab_size=262144,
    block_pattern=("attn_local", "attn_local", "attn_local", "attn_local",
                   "attn_local", "attn"),
    window=1024,
    norm="rmsnorm",
    act="gelu",
    rope_theta=1e6,
    tie_embeddings=True,
)
