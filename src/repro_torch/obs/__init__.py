"""Unified telemetry for the port: metrics registry, host-side span
tracing, pluggable sinks, and a bounded ``torch.profiler`` capture.

Port of ``repro/obs``.  Quick use::

    from repro_torch import obs

    obs.configure(jsonl="metrics.jsonl", console=True)
    with obs.get().span("serve.decode_step", slots=4):
        ...                     # launch work
    obs.get().finalize()        # flush metric snapshots, close sinks

Everything is host-side Python: instrumented runs give the same outputs,
bit for bit, as uninstrumented ones and build the same programs
(``tests/test_torch_obs_parity.py``).  The event stream follows the JAX
package's schema (``docs/OBSERVABILITY.md``), which
``tools/check_metrics_schema.py`` checks.
"""

from .metrics import (
    Counter, Gauge, Histogram, Registry,
    DEFAULT_TIME_EDGES, RATIO_EDGES,
    percentile, percentile_ms, summarize_samples,
)
from .events import (
    Telemetry, JsonlSink, MemorySink, ConsoleSink,
    configure, get, reset, provenance,
)
from .profiler import ProfileWindow

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "DEFAULT_TIME_EDGES", "RATIO_EDGES",
    "percentile", "percentile_ms", "summarize_samples",
    "Telemetry", "JsonlSink", "MemorySink", "ConsoleSink",
    "configure", "get", "reset", "provenance",
    "ProfileWindow",
]
