"""PyTorch port of the CABA serving stack (``repro``), for NVIDIA Hopper.

The package mirrors ``repro``'s module paths so a reader finds each
counterpart.  Models are plain functions over a params dict that mirrors
the JAX pytree leaf for leaf (``convert.params_from_numpy`` carries weights
across).  Entry points run on the card unless the caller passes
``device="cpu"``; a kernel wrapper runs its plain PyTorch form only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Upload a host array without waiting for the device.

    For the card the array is staged in page-locked host memory and the
    transfer is queued on the current stream: a copy from pageable memory
    may wait for the stream.  PyTorch's caching host allocator keeps the
    staging block until the queued copy has run and then reuses it, so the
    caller may reuse ``arr`` at once.  For the CPU the result is a copy."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.from_numpy(np.array(arr, copy=True)).to(dev)
    src = torch.from_numpy(np.ascontiguousarray(arr))
    staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    staged.copy_(src)
    return staged.to(dev, non_blocking=True)
