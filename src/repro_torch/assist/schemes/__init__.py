"""Compression schemes -- the compress-kind assist payloads (paper 5):
BDI (uniform and per-block packed), FPC and C-Pack, registered as
``CompressTask``s in ``repro_torch.assist.registry``."""
from repro_torch.assist.schemes import bdi, cpack, fpc

__all__ = ["bdi", "cpack", "fpc"]
