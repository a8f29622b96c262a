"""Assist framework of the port: the registry of tasks (the KV cache's
compress schemes and cold-page prefetch) and the controller that triggers
and throttles them."""
from repro_torch.assist.controller import AssistController
from repro_torch.assist.registry import REGISTRY, AssistRegistry
from repro_torch.assist.spec import AssistSpec
from repro_torch.assist.tasks import (H100_SXM, TPU_V5E, AssistDecision,
                                      CompressTask, HardwareSpec,
                                      PrefetchTask, RooflineTerms,
                                      SiteDescriptor)

__all__ = ["AssistController", "AssistRegistry", "AssistSpec",
           "AssistDecision", "CompressTask", "HardwareSpec", "H100_SXM",
           "PrefetchTask", "REGISTRY", "TPU_V5E", "RooflineTerms",
           "SiteDescriptor"]
