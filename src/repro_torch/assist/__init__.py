"""Assist framework of the port: the KV compress site's trigger/throttle."""
from repro_torch.assist.controller import AssistController
from repro_torch.assist.spec import AssistSpec
from repro_torch.assist.tasks import (H100_SXM, TPU_V5E, AssistDecision,
                                      HardwareSpec, RooflineTerms,
                                      SiteDescriptor)

__all__ = ["AssistController", "AssistSpec", "AssistDecision",
           "HardwareSpec", "H100_SXM", "TPU_V5E", "RooflineTerms",
           "SiteDescriptor"]
