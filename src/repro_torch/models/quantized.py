"""Model-level compressed weights: the paper's compressed-weight site.

Counterpart of ``repro.models.quantized``.  A weight leaf is either a
plain bf16 matrix or ``{"q8": int8[..., K, N], "s8": f32[..., 1, N]}``
(per-output-column absmax scales, one K-group).  ``quantize_params``
rewrites a params tree into that format (the reference's names and size
threshold); norms, biases and the embeddings stay raw.

``qmatmul(x, p, name)`` is the one consumer of a weight: a q8 leaf goes
through ``kernels.fused_matmul.ops.matmul_q8`` with ``gk = K`` -- the CUDA
kernel streams int8 bytes and dequantizes in registers, on the CPU its
plain form -- and a raw leaf is ``x @ w``.  The reference's consumer
(``getw``) rounds the scale to bf16 and the dequantized weight to bf16,
then leaves the product to XLA; the port rounds the scale the same way
(``bf16_scale``) but applies it to the f32 sum, so the two differ only by
the per-element rounding of the reference's dequantized weight.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_matmul.ops import matmul_q8


def qmatmul(x, p, name: str):
    """x [..., K] @ the weight ``p[name]`` -> [..., N] in bf16."""
    w = p[name]
    if not (isinstance(w, dict) and "q8" in w):
        return x @ w
    q8, s8 = w["q8"], w["s8"]
    K, N = q8.shape
    y = matmul_q8(x.reshape(-1, K).contiguous(), q8, s8, gk=K,
                  bf16_scale=True)
    return y.reshape(*x.shape[:-1], N)


def quantize_leaf(w):
    """bf16/f32[..., K, N] -> {"q8": int8, "s8": f32[..., 1, N]}.

    Computed one leading index at a time, so a full-width stacked leaf
    never holds an f32 copy of the whole stack."""
    K, N = w.shape[-2:]
    flat = w.reshape(-1, K, N)
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((flat.shape[0], 1, N), dtype=torch.float32,
                    device=w.device)
    for i in range(flat.shape[0]):
        wf = flat[i].float()
        absmax = wf.abs().amax(dim=0, keepdim=True)
        s[i] = torch.where(absmax > 0, absmax / 127.0,
                           torch.ones_like(absmax))
        q[i] = torch.clamp(torch.round(wf / s[i]), -127, 127).to(torch.int8)
    return {"q8": q.reshape(w.shape), "s8": s.reshape(w.shape[:-2] + (1, N))}


def dequantize_leaf(v):
    return (v["q8"].float() * v["s8"]).to(torch.bfloat16)


# leaf names consumed via matmul (embed/unembed excluded: gather and the
# tied-logits path keep them raw)
_QUANT_NAMES = {
    "wq", "wk", "wv", "wo", "wi", "wg", "wr",
    "wq_a", "wq_b", "wkv_a", "wkv_b",
    "in_proj", "out_proj", "lora_A", "lora_B",
}


def quantize_params(params, *, min_size: int = 4096,
                    names: set | None = None):
    """Rewrite matmul weights into the compressed format (serve path)."""
    names = _QUANT_NAMES if names is None else names

    def walk(node):
        if isinstance(node, list):
            return [walk(x) for x in node]
        if isinstance(node, tuple):
            return tuple(walk(x) for x in node)
        if not isinstance(node, dict):
            return node
        return {k: (quantize_leaf(v)
                    if (k in names and isinstance(v, torch.Tensor)
                        and v.dim() >= 2 and v.numel() >= min_size
                        and v.is_floating_point())
                    else walk(v))
                for k, v in node.items()}

    return walk(params)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + f"['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + f"[{i}]")
    else:
        yield path, tree


def params_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(params))


def max_dequant_error(params, qparams) -> float:
    """Worst relative dequant error across quantized leaves (tests)."""
    by_path = dict(_leaves(params))
    worst = 0.0

    def walk(node, prefix):
        nonlocal worst
        if isinstance(node, dict) and "q8" in node:
            of = by_path[prefix].float()
            deq = dequantize_leaf(node).float()
            denom = float(of.abs().max()) + 1e-9
            worst = max(worst, float((deq - of).abs().max()) / denom)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + f"['{k}']")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + f"[{i}]")

    walk(qparams, "")
    return worst
