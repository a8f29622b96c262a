"""Compression schemes -- the compress-kind assist payloads (paper 5):
BDI (uniform and per-block packed), FPC and C-Pack, bit planes and the
block quantizers, registered as ``CompressTask``s in
``repro_torch.assist.registry``; ``selector`` is BestOfAll (paper 7.3)."""
from repro_torch.assist.schemes import (bdi, cpack, fpc, planes, quant,
                                        selector)

__all__ = ["bdi", "cpack", "fpc", "planes", "quant", "selector"]
