"""Metrics primitives: counters, gauges, fixed-bucket histograms, and the
exact-percentile utilities the serving SLO summaries are built on.

Port of ``repro/obs/metrics.py`` (pure Python, copied so the port imports
nothing of the JAX package).

Design rules (they are what make the subsystem safe to leave on):

  * **Host-side only.**  Nothing here touches torch — observing a metric
    is a few dict/float operations, so instrumentation can run inside the
    engines' dispatch loops without perturbing what they build or compute
    (the inertness contract ``tests/test_torch_obs_parity.py`` holds).
  * **Fixed bucket edges.**  Histograms bucket into edges chosen at
    construction, so percentile estimates are deterministic functions of
    the observed multiset — two runs that observe the same values report
    the same p99, and merging shards of a histogram is associative on
    everything percentiles read (counts/min/max; the float ``sum`` is
    associative only to rounding, which ``merge`` documents).
  * **Monotone counters, last-write gauges.**  ``Counter.inc`` accepts
    only non-negative increments and *returns the accumulated value*, so
    a caller that mirrors an exact host-side accumulation (the train
    engine's float64 comm total) gets bit-identical totals — same adds,
    same order.

The exact (non-bucketed) :func:`percentile` is what
``serving.driver.summarize`` uses: raw-sample percentiles with the
degenerate cases (empty, single sample, ``None`` holes) guarded here once
instead of at every call site.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "DEFAULT_TIME_EDGES", "RATIO_EDGES",
    "percentile", "percentile_ms", "summarize_samples",
]

#: log-spaced wall-time bucket edges (seconds), 100 us .. 500 s — wide
#: enough for a CPU bench tick and a full training run alike.
DEFAULT_TIME_EDGES: Tuple[float, ...] = tuple(
    round(m * 10.0 ** e, 10) for e in range(-4, 3) for m in (1.0, 2.5, 5.0)
)

#: linear edges for occupancy/ratio metrics in [0, 1].
RATIO_EDGES: Tuple[float, ...] = tuple(round(i / 10.0, 10) for i in range(11))


class Counter:
    """Monotone accumulator.  ``inc`` returns the post-increment total so
    exact host-side accumulations can be mirrored add-for-add."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: Optional[threading.RLock] = None):
        self.name = name
        self.value = 0.0
        self._lock = lock or threading.RLock()

    def inc(self, n: float = 1.0) -> float:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self.value += n
            return self.value

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value (occupancies, pool levels, rates)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: Optional[threading.RLock] = None):
        self.name = name
        self.value: Optional[float] = None
        self._lock = lock or threading.RLock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> Dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with deterministic percentiles.

    Bucket ``i < len(edges)`` counts observations ``v <= edges[i]``
    (with ``v > edges[i-1]`` for ``i > 0``); the final bucket is the
    overflow.  ``percentile`` walks the cumulative counts to the target
    rank and reports that bucket's upper edge clamped to the observed
    max (the overflow bucket reports the max itself) — a deterministic
    upper bound on the nearest-rank sample percentile that two
    differently sharded runs agree on after :meth:`merge`.
    """

    __slots__ = ("name", "edges", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, name: str,
                 edges: Sequence[float] = DEFAULT_TIME_EDGES,
                 lock: Optional[threading.RLock] = None):
        edges = tuple(float(e) for e in edges)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram {name}: edges must be non-empty and strictly "
                f"increasing, got {edges!r}")
        self.name = name
        self.edges = edges
        self.counts: List[int] = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = lock or threading.RLock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect.bisect_left(self.edges, v)] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        """Deterministic q-th percentile bound (q in [0, 100]); None when
        empty.  For a single sample every q returns that sample."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q={q} outside [0, 100]")
        with self._lock:
            if self.count == 0:
                return None
            # rank 1..count (ceil of q% of count); q=0 reads the first sample
            rank = max(1, min(self.count, int(-(-q * self.count // 100))))
            cum = 0
            for i, c in enumerate(self.counts):
                cum += c
                if cum >= rank:
                    if i < len(self.edges):
                        return min(self.edges[i], self.max)
                    return self.max
            return self.max  # unreachable: counts sum to count

    def merge(self, other: "Histogram") -> "Histogram":
        """New histogram holding both sides' observations.  Associative on
        counts/count/min/max (ints and order-free extrema); ``sum`` is a
        float add, associative only to rounding."""
        if other.edges != self.edges:
            raise ValueError(
                f"cannot merge histograms with different edges "
                f"({self.name}: {len(self.edges)}, "
                f"{other.name}: {len(other.edges)})")
        out = Histogram(self.name, self.edges)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        mins = [m for m in (self.min, other.min) if m is not None]
        maxs = [m for m in (self.max, other.max) if m is not None]
        out.min = min(mins) if mins else None
        out.max = max(maxs) if maxs else None
        return out

    def snapshot(self) -> Dict:
        with self._lock:
            return {"type": "histogram", "count": self.count,
                    "sum": self.sum, "min": self.min, "max": self.max,
                    "edges": list(self.edges), "counts": list(self.counts),
                    "p50": self.percentile(50), "p99": self.percentile(99)}


class Registry:
    """Name -> metric map with get-or-create accessors.

    One registry per telemetry instance; creation and all metric writes
    share one re-entrant lock, so the staging thread, the driver pump
    thread, and the main loop can all report concurrently."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.RLock()

    def _get(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name, self._lock))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, self._lock))

    def histogram(self, name: str,
                  edges: Sequence[float] = DEFAULT_TIME_EDGES) -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, edges, self._lock))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str):
        return self._metrics.get(name)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, Dict]:
        """{name: metric snapshot dict} for every registered metric."""
        with self._lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}

    def prometheus_text(self) -> str:
        """Prometheus text-exposition snapshot (names dot->underscore,
        histograms in cumulative ``le`` form)."""
        lines: List[str] = []
        for name, snap in self.snapshot().items():
            pname = name.replace(".", "_").replace("-", "_")
            kind = snap["type"]
            lines.append(f"# TYPE {pname} {kind}")
            if kind == "histogram":
                cum = 0
                for edge, c in zip(snap["edges"], snap["counts"]):
                    cum += c
                    lines.append(f'{pname}_bucket{{le="{edge:g}"}} {cum}')
                lines.append(
                    f'{pname}_bucket{{le="+Inf"}} {snap["count"]}')
                lines.append(f"{pname}_sum {snap['sum']:g}")
                lines.append(f"{pname}_count {snap['count']}")
            else:
                v = snap["value"]
                lines.append(f"{pname} {'NaN' if v is None else f'{v:g}'}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# exact raw-sample percentiles (the SLO-summary path)
# ---------------------------------------------------------------------------


def percentile(values: Iterable[Optional[float]], q: float
               ) -> Optional[float]:
    """Exact linear-interpolation percentile over raw samples.

    Guards the degenerate cases the serving summaries hit: ``None``
    entries are dropped (unfinished requests), an empty sample set
    returns ``None`` instead of raising, and a single sample answers
    every q with itself.  Matches ``numpy.percentile``'s default
    (linear) interpolation bit-for-bit so the migration off the old
    ad-hoc ``np.percentile`` calls changed no reported number."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    vals = sorted(float(v) for v in values if v is not None)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    pos = q / 100.0 * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def percentile_ms(values: Iterable[Optional[float]], q: float
                  ) -> Optional[float]:
    """:func:`percentile` over seconds, reported in milliseconds."""
    p = percentile(values, q)
    return None if p is None else p * 1e3


def summarize_samples(values: Iterable[Optional[float]]) -> Dict:
    """{count, mean, p50, p99, min, max} over raw samples, all None-safe."""
    vals = [float(v) for v in values if v is not None]
    if not vals:
        return {"count": 0, "mean": None, "p50": None, "p99": None,
                "min": None, "max": None}
    return {"count": len(vals), "mean": sum(vals) / len(vals),
            "p50": percentile(vals, 50), "p99": percentile(vals, 99),
            "min": min(vals), "max": max(vals)}
