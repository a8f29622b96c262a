"""build_model: the public model API the serving engine consumes.

Counterpart of ``repro.models.model``: ``build_model(cfg)`` returns plain
functions over an explicit params dict (the JAX pytree layout).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ModelFns:
    cfg: ArchConfig
    init: Callable            # generator -> params (on generator.device)
    # (params, batch, max_len, *, kv_mode) -> (logits, state)
    prefill: Callable
    # (params, state, tokens) -> (logits, state)  [state updated in place]
    decode_step: Callable
    # (batch, max_len, *, kv_mode, device) -> fresh dense decode state
    init_state: Callable
    # (params, pools, tokens, block_table, lengths, *, has_warm, backend)
    #   -> (logits, pools)   [pools updated in place]
    paged_decode_step: Callable


def build_model(cfg: ArchConfig) -> ModelFns:
    T.check_supported(cfg)

    def init(gen: torch.Generator):
        return T.stack_init(gen, cfg)

    def prefill(params, batch, max_len: int, *, kv_mode: str = "bf16"):
        # ``batch`` may carry "true_len" (int32[B]): tokens beyond it are
        # right-padding from prompt-length bucketing (see prompt_bucket)
        return T.stack_apply_seq(cfg, params, batch, want_state=True,
                                 max_len=max_len, kv_mode=kv_mode)

    def decode_step(params, state, tokens):
        return T.stack_decode_step(cfg, params, state, tokens)

    def init_state(batch: int, max_len: int, *, kv_mode: str = "bf16",
                   device=None):
        return T.stack_init_state(cfg, batch, max_len, kv_mode, device)

    def paged_decode_step(params, pools, tokens, block_table, lengths, *,
                          has_warm: bool = True, backend: str = "gather"):
        return T.stack_paged_decode_step(cfg, params, pools, tokens,
                                         block_table, lengths,
                                         has_warm=has_warm, backend=backend)

    return ModelFns(cfg, init, prefill, decode_step, init_state,
                    paged_decode_step)


# ---------------------------------------------------------------------------
# prompt-length bucketing
# ---------------------------------------------------------------------------

def prompt_bucket(plen: int, max_len: int, quantum: int = 16) -> int:
    """Padded prefill length for a ``plen``-token prompt: ``quantum * 2**k``
    capped at ``max_len``, so prompts map onto few distinct shapes."""
    if plen > max_len:
        raise ValueError(f"prompt length {plen} exceeds max_len {max_len}")
    b = quantum
    while b < plen:
        b *= 2
    return min(b, max_len)


def n_prompt_buckets(max_len: int, quantum: int = 16) -> int:
    """How many distinct bucket shapes ``prompt_bucket`` can emit."""
    return len({prompt_bucket(p, max_len, quantum)
                for p in range(1, max_len + 1)})
