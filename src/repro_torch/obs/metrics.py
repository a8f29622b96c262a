"""MetricsRegistry: the counter/gauge/histogram substrate the pool, store,
policy and engine bind their handles on.

A metric handle is a plain slotted object whose ``inc`` is one attribute
add; components resolve handles once at construction.  With telemetry off
they receive ``NULL_REGISTRY`` and every handle is a shared no-op.  Names
follow the Prometheus grammar and labels are keyword arguments, so a
series is addressed the same way as in ``repro.obs.metrics``.
"""
from __future__ import annotations

import bisect
import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(lo: float, hi: float, factor: float = 2.0) -> tuple:
    """Fixed log-spaced histogram bucket bounds: lo, lo*f, ... >= hi."""
    if lo <= 0 or hi <= lo or factor <= 1.0:
        raise ValueError("need 0 < lo < hi and factor > 1")
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


SECONDS_BUCKETS = log_buckets(1e-5, 10.0)
TOKENS_BUCKETS = log_buckets(1.0, 16384.0)


class Counter:
    """Monotonic counter.  ``inc`` is the only mutator."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n


class Gauge:
    """Point-in-time value (occupancy, queue depth, peaks)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v):
        self.value = v

    def set_max(self, v):
        if v > self.value:
            self.value = v


class Histogram:
    """Fixed-bucket histogram; values above the last bound land in +Inf."""
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds=SECONDS_BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def value(self):
        return self.count


class _NullMetric:
    """Shared no-op handle for disabled telemetry."""
    __slots__ = ()
    value = 0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def set_max(self, v):
        pass

    def observe(self, v):
        pass


NULL_METRIC = _NullMetric()

_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named, labeled metric families.  The same (name, labels) always
    yields the same handle, so components sharing a registry share the
    series."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, tuple] = {}   # name -> (type, help, kids)

    def _get(self, typ: str, name: str, help: str, labels: dict, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name {k!r}")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.setdefault(name, (typ, help, {}))
            if fam[0] != typ:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam[0]}, not {typ}")
            m = fam[2].get(key)
            if m is None:
                m = fam[2][key] = _TYPES[typ](**kw)
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets=SECONDS_BUCKETS, **labels) -> Histogram:
        return self._get("histogram", name, help, labels, bounds=buckets)

    def get_value(self, name: str, **labels):
        """Read one series' value (None if absent)."""
        fam = self._families.get(name)
        if fam is None:
            return None
        m = fam[2].get(tuple(sorted((k, str(v)) for k, v in labels.items())))
        return None if m is None else m.value


class NullRegistry:
    """Disabled registry: hands out the shared no-op metric."""

    enabled = False

    def counter(self, name, help="", **labels):
        return NULL_METRIC

    def gauge(self, name, help="", **labels):
        return NULL_METRIC

    def histogram(self, name, help="", buckets=SECONDS_BUCKETS, **labels):
        return NULL_METRIC

    def get_value(self, name, **labels):
        return None


NULL_REGISTRY = NullRegistry()
