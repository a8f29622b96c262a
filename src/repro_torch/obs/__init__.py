"""Telemetry substrate of the port (counters, gauges, histograms)."""
from repro_torch.obs.metrics import (NULL_REGISTRY, MetricsRegistry,
                                     log_buckets)

__all__ = ["MetricsRegistry", "NULL_REGISTRY", "log_buckets"]
