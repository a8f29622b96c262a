"""deepseek-v2-236b [moe]: 60L d=5120 128H (GQA kv=128) d_ff(expert)=1536
vocab=102400, MoE 2 shared + 160 routed top-6, MLA kv_lora=512.
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,            # MLA: all heads read the shared latent
    d_ff=12288,                # dense FFN on the first layer(s)
    vocab_size=102400,
    block_pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    rope_theta=1e4,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_routed=160, n_shared=2, top_k=6, d_expert=1536,
                  first_dense=1),
)
