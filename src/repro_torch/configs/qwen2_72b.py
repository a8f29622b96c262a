"""qwen2-72b [dense]: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 --
GQA with QKV bias; the PP demonstration arch. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    block_pattern=("attn",),
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=1e6,
)
