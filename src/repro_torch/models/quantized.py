"""Weight access point of the model code.

``getw(p, name)`` fetches a weight from a params dict; a compressed leaf
(``{"q8": int8, "s8": scales}``) dequantizes to bf16 at the consumer.
Writing that format (``quantize_params``) is not ported yet.
"""
from __future__ import annotations

import torch


def getw(p, name: str):
    """Fetch a weight from a params dict, dequantizing if compressed."""
    v = p[name]
    if isinstance(v, dict) and "q8" in v:
        return v["q8"].to(torch.bfloat16) * v["s8"].to(torch.bfloat16)
    return v
