"""AssistRegistry: the Assist Warp Store (paper 4.3, Figure 5).

Counterpart of ``repro.assist.registry`` holding the tasks the port has:
the warm tier's per-token ``int8`` (its quantizer is
``serving.kv_cache.quantize_token``; the registry keeps its traits for the
controller), the cold tier's lossless ``bdi_packed`` and ``fpc`` codecs,
and the ``coldpage`` prefetch queue.  Uniform BDI, C-Pack, bit planes and
the other quantizers are not ported yet.
"""
from __future__ import annotations

from repro_torch.assist.schemes import bdi, fpc
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


def default_registry() -> AssistRegistry:
    r = AssistRegistry()
    r.register(CompressTask("int8", decomp_ops_per_byte=1.0))
    r.register(CompressTask("bdi_packed", decomp_ops_per_byte=1.0,
                            compress=bdi.compress_packed,
                            decompress=bdi.decompress_packed, lossless=True))
    r.register(CompressTask("fpc", decomp_ops_per_byte=2.0,
                            compress=fpc.compress,
                            decompress=fpc.decompress, lossless=True))
    r.register(PrefetchTask("coldpage"))
    return r


REGISTRY = default_registry()
