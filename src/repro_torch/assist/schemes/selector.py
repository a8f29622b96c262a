"""BestOfAll scheme selection (paper Fig. 12/13 and 7.3).

Counterpart of ``repro.assist.schemes.selector``: compress a tensor with
each scheme, report the true ratios, and pick the best, optionally
weighing each ratio against its decompression cost (the paper's 7.3
remark).  As in the reference, ``"bdi"`` here is packed BDI and ``"fpc"``
FPC, both host codecs run on the tensor's host array; C-Pack, bit planes
and the quantizers run on the tensor's device.  Bit planes are skipped
for 1-byte dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.assist import bytesops as bo
from repro_torch.assist.schemes import bdi, cpack, fpc, planes, quant

# decompression cost in ops per uncompressed byte (the reference's
# calibration; used by the controller's throttle rule, paper 4.4)
DECOMP_OPS_PER_BYTE = {
    "bdi": 1.0,       # masked add + widen
    "fpc": 2.0,       # pattern select + splice
    "cpack": 2.0,     # dict gather + splice
    "planes": 1.5,    # nibble gather + interleave
    "int8": 1.0,      # scale multiply
    "fp8": 1.0,
    "int4": 1.5,
    "raw": 0.0,
}

LOSSLESS = ("bdi", "fpc", "cpack", "planes")


@dataclasses.dataclass(frozen=True)
class SchemeChoice:
    name: str
    ratio: float
    compressed: Any | None = None


def measure_ratios(x, schemes: tuple[str, ...] = LOSSLESS,
                   keep: bool = False) -> dict[str, SchemeChoice]:
    """Compress ``x`` with each scheme and report true ratios."""
    out: dict[str, SchemeChoice] = {}
    for name in schemes:
        if name == "bdi":
            c = bdi.compress_packed(bo.host_array(x))
        elif name == "fpc":
            c = fpc.compress(bo.host_array(x))
        elif name == "cpack":
            c = cpack.compress(x)
        elif name == "planes":
            if x.element_size() < 2:
                continue
            c = planes.compress(x)
        elif name in quant.KINDS:
            c = quant.compress(x, name)
        else:
            raise ValueError(name)
        out[name] = SchemeChoice(name, float(c.ratio()), c if keep else None)
    return out


def best_of_all(x, schemes: tuple[str, ...] = LOSSLESS,
                cost_weight: float = 0.0) -> SchemeChoice:
    """Pick argmax ratio (cost_weight=0 is the paper's BestOfAll;
    cost_weight>0 penalizes expensive decompressors, paper 7.3)."""
    ratios = measure_ratios(x, schemes)
    if not ratios:
        return SchemeChoice("raw", 1.0)

    def score(c: SchemeChoice) -> float:
        return c.ratio - cost_weight * DECOMP_OPS_PER_BYTE[c.name]
    best = max(ratios.values(), key=score)
    if best.ratio <= 1.0:
        return SchemeChoice("raw", 1.0)
    return best
