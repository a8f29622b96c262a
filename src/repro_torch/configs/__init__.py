"""Assigned-architecture registry: ``--arch <id>`` resolves here."""
from repro_torch.configs.base import (ArchConfig, ShapeConfig, MLAConfig, MoEConfig,
                                SSMConfig, RWKVConfig, SHAPES, TRAIN_4K,
                                PREFILL_32K, DECODE_32K, LONG_500K, reduced,
                                SMOKE_SHAPE)

from repro_torch.configs import (deepseek_v2_236b, deepseek_v2_lite_16b,
                           zamba2_1p2b, rwkv6_7b, qwen2_7b, gemma3_4b,
                           starcoder2_3b, qwen2_72b, hubert_xlarge,
                           llava_next_mistral_7b)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        deepseek_v2_236b, deepseek_v2_lite_16b, zamba2_1p2b, rwkv6_7b,
        qwen2_7b, gemma3_4b, starcoder2_3b, qwen2_72b, hubert_xlarge,
        llava_next_mistral_7b)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


# (arch x shape) applicability (DESIGN.md 5): returns None if runnable, else
# the skip reason recorded in EXPERIMENTS.md.
def skip_reason(arch: ArchConfig, shape: ShapeConfig) -> str | None:
    if shape.kind == "decode" and not arch.causal:
        return "encoder-only: no decode step"
    if shape.name == "long_500k":
        subquadratic = arch.family in ("ssm", "hybrid")
        if not subquadratic:
            return ("full quadratic attention at 500k context; assignment "
                    "says run only for SSM/hybrid/linear-attn")
    return None


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells in deterministic order."""
    out = []
    for aname in sorted(ARCHS):
        for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            a, s = ARCHS[aname], SHAPES[sname]
            r = skip_reason(a, s)
            if r is None or include_skipped:
                out.append((a, s, r))
    return out
