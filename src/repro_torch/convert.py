"""Carry a parameter tree across from numpy to PyTorch.

``params_from_numpy`` takes the reference's params already turned into
numpy by the caller (e.g. ``jax.tree.map(np.asarray, params)``), so this
package never imports JAX.  The tree layout is kept as it is (dicts,
tuples, lists), one tensor per leaf.  bf16 leaves travel as their bit
pattern: numpy bf16 (ml_dtypes) has no PyTorch counterpart, so the array
is viewed as uint16 and the tensor viewed back as torch.bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch


def leaf_from_numpy(x, device="cpu") -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """dict/tuple/list tree of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return leaf_from_numpy(tree, device)
