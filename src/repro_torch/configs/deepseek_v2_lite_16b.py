"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H d_ff(expert)=1408 vocab=102400,
MoE 2 shared + 64 routed top-6, MLA kv_lora=512 (no q-LoRA in lite).
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                # dense FFN on the first layer
    vocab_size=102400,
    block_pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                  first_dense=1),
)
