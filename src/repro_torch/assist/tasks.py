"""Planning vocabulary of the assist tasks, as far as the demotion verdict
needs it.

Counterpart of ``repro.assist.tasks``: a ``SiteDescriptor`` (what an assist
site moves), ``RooflineTerms`` (the modeled step), an ``AssistDecision``
(the controller's verdict) and the compress tasks' cost traits.  The
hardware constants the reference keeps at module level are a
``HardwareSpec`` parameter here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Rates the roofline model divides by."""
    name: str
    peak_flops: float      # dense bf16 matrix rate, FLOP/s
    hbm_bw: float          # device memory, bytes/s
    ici_bw: float          # one inter-chip link, bytes/s
    vpu_ops: float         # elementwise (dequantize) operations/s


#: NVIDIA H100 SXM, from NVIDIA's data sheet: published peaks, not measured
#: on any card (bf16 dense tensor-core rate, HBM3 bandwidth, one direction
#: of NVLink, the FP32 CUDA-core rate for the elementwise dequantize).
H100_SXM = HardwareSpec("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                        ici_bw=450e9, vpu_ops=67e12)

#: The reference's TPU v5e constants (repro.assist.tasks), for parity runs
#: whose decisions must match the reference's.
TPU_V5E = HardwareSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       ici_bw=50e9, vpu_ops=4 * 8 * 128 * 940e6)

MIN_RATIO = 1.2           # paper 6: require 20% compressibility

KINDS = ("compress", "memoize", "prefetch")


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-device seconds for one step."""
    compute: float
    memory: float
    collective: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute, "memory": self.memory,
                 "collective": self.collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        # perfect-overlap lower bound: the dominant term
        return max(self.compute, self.memory, self.collective)


@dataclasses.dataclass(frozen=True)
class SiteDescriptor:
    """One assist opportunity in a step: ``term`` is the roofline term the
    task relieves, ``bytes_per_step`` what the site moves per step."""
    name: str
    bytes_per_step: float
    term: str
    lossless_required: bool
    measured_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class AssistDecision:
    """The controller's verdict for one (task, site) pair."""
    site: str
    enabled: bool
    scheme: str
    ratio: float
    reason: str
    kind: str = "compress"


@dataclasses.dataclass(frozen=True)
class CompressTask:
    """Cost traits of one compression scheme."""
    name: str
    decomp_ops_per_byte: float


#: the schemes a KV site can name (the warm tier is per-token int8)
COMPRESS_TASKS = {"int8": CompressTask("int8", decomp_ops_per_byte=1.0)}
