"""zamba2-1.2b [hybrid]: 38L d=2048 32H d_ff=8192 vocab=32000, ssm_state=64,
Mamba2 backbone + SHARED attention block invoked every 6th position (weights
shared across invocations -- the Zamba2 signature). [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=42,               # 36 mamba2 + 6 shared-attn invocations (6x7)
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                   "mamba2", "shared_attn"),
    window=4096,               # shared attn uses a bounded window -> 500k OK
    norm="rmsnorm",
    act="gelu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
)
