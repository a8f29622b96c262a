"""llava-next-mistral-7b [vlm]: 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 -- mistral-7b backbone; the vision frontend (anyres tiling) is a
STUB: inputs include precomputed patch embeddings [B, n_patches, d_model]
prepended to the text. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    rope_theta=1e6,
    frontend="vision",
    n_patches=2304,            # anyres: 4 tiles x 576 patches (24x24)
)
