"""rwkv6-7b [ssm]: 32L d=4096 (attention-free) d_ff=14336 vocab=65536 --
Finch with data-dependent decay. [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                # wkv heads = d_model / head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    norm="layernorm",
    act="silu",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
)
