"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 --
GQA + RoPE, layernorm/gelu. [arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    block_pattern=("attn",),
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    rope_theta=1e5,
)
