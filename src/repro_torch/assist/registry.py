"""AssistRegistry: the Assist Warp Store (paper 4.3, Figure 5).

Counterpart of ``repro.assist.registry`` holding the tasks the port has,
in the reference's order and with its traits: the lossless codecs --
uniform ``bdi`` and ``cpack`` on tensors (their kernels run on the card),
the cold tier's packed ``bdi_packed`` and ``fpc`` on host arrays, bit
``planes`` on tensors -- the block quantizers ``int8``, ``fp8`` and
``int4``, and the ``coldpage`` prefetch queue.  The memoize kind (the
reference's ``lut`` and ``prefix``) is not ported yet.
"""
from __future__ import annotations

import functools
from typing import Optional

from repro_torch.assist.schemes import bdi, cpack, fpc, planes, quant
from repro_torch.assist.tasks import KINDS, CompressTask, PrefetchTask


class AssistRegistry:
    """Registry of assist tasks, keyed by (kind, name)."""

    def __init__(self):
        self._by_key: dict[tuple[str, str], object] = {}

    def register(self, task):
        key = (task.kind, task.name)
        if key in self._by_key:
            raise ValueError(f"{task.kind} task {task.name!r} already "
                             f"registered")
        if task.kind not in KINDS:
            raise ValueError(f"unknown task kind {task.kind!r}")
        self._by_key[key] = task
        return task

    def get(self, name: str, kind: str = "compress"):
        try:
            return self._by_key[(kind, name)]
        except KeyError:
            raise KeyError(f"no {kind} task {name!r} registered "
                           f"(have: {self.names(kind)})") from None

    def names(self, kind: str = "compress") -> list[str]:
        return [n for k, n in self._by_key if k == kind]

    def kinds(self) -> list[str]:
        return sorted({k for k, _ in self._by_key})

    def tasks(self, kind: Optional[str] = None) -> list:
        return [t for (k, _), t in self._by_key.items()
                if kind is None or k == kind]

    def lossless_names(self) -> list[str]:
        return [t.name for t in self.tasks("compress") if t.lossless]


def default_registry() -> AssistRegistry:
    r = AssistRegistry()
    r.register(CompressTask("bdi", decomp_ops_per_byte=1.0,
                            compress=bdi.compress_uniform,
                            decompress=bdi.decompress_uniform, lossless=True))
    r.register(CompressTask("bdi_packed", decomp_ops_per_byte=1.0,
                            compress=bdi.compress_packed,
                            decompress=bdi.decompress_packed, lossless=True,
                            host=True))
    r.register(CompressTask("fpc", decomp_ops_per_byte=2.0,
                            compress=fpc.compress,
                            decompress=fpc.decompress, lossless=True,
                            host=True))
    r.register(CompressTask("cpack", decomp_ops_per_byte=2.0,
                            compress=cpack.compress,
                            decompress=cpack.decompress, lossless=True,
                            jit_compress=True))
    r.register(CompressTask("planes", decomp_ops_per_byte=1.5,
                            compress=planes.compress,
                            decompress=planes.decompress, lossless=True,
                            jit_compress=True))
    for kind, ops in (("int8", 1.0), ("fp8", 1.0), ("int4", 1.5)):
        r.register(CompressTask(kind, decomp_ops_per_byte=ops,
                                compress=functools.partial(quant.compress,
                                                           kind=kind),
                                decompress=quant.decompress,
                                jit_compress=True))
    r.register(PrefetchTask("coldpage"))
    return r


REGISTRY = default_registry()
