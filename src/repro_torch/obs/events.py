"""Telemetry core: sinks, spans, structured events, program-build events.

Port of ``repro/obs/events.py``.  A :class:`Telemetry` owns one
:class:`~repro_torch.obs.metrics.Registry` and a list of sinks.
Instrumentation points in the serving runtime and the training loop talk
to the module-level default instance (``repro_torch.obs.get()``);
launchers call :func:`configure` once to attach sinks from CLI flags.
Every hook is a host-side Python effect that adds no device
synchronization, so instrumented runs give the same tokens and
parameters, bit for bit, and build the same programs
(``tests/test_torch_obs_parity.py``).  With ``enabled = False`` every
hook returns before it touches the registry.

Event stream schema (one JSON object per line, the JAX package's, so
``tools/check_metrics_schema.py`` checks either package's stream):

  line 1           ``{"kind": "provenance", "torch_version": ..., ...}``
  span             ``{"kind": "span", "name", "ts", "dur_s", ...attrs}``
  event            ``{"kind": "event", "name", "ts", ...attrs}``
  compile          ``{"kind": "compile", "name", "ts", ...attrs}``
                   (a program built: the port's counterpart of a trace)
  metric snapshot  ``{"kind": "metric", "name", "ts", ...snapshot}``
                   (one per registered metric, emitted by ``finalize``)
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import threading
import time
from typing import Dict, List, Optional

from .metrics import DEFAULT_TIME_EDGES, Registry
from .profiler import ProfileWindow

__all__ = [
    "Telemetry", "JsonlSink", "MemorySink", "ConsoleSink",
    "configure", "get", "reset", "provenance",
]


def provenance() -> Dict:
    """Environment fingerprint stamped on every event stream: enough to
    interpret a timing without the shell that produced it.  Carries the
    schema's ``jax_version`` key as ``None`` (the port runs no JAX)."""
    info: Dict = {"kind": "provenance",
                  "ts": time.time(),
                  "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                  "jax_version": None}
    try:
        import torch

        cuda = torch.cuda.is_available()
        info.update(torch_version=torch.__version__,
                    cuda_version=torch.version.cuda,
                    backend="cuda" if cuda else "cpu",
                    device_kind=(torch.cuda.get_device_name(0) if cuda
                                 else "cpu"),
                    device_count=torch.cuda.device_count() if cuda else 1,
                    platform="gpu" if cuda else "cpu")
    except Exception:  # torch not initialisable: still stamp the time
        info.update(torch_version=None, cuda_version=None, backend=None,
                    device_kind=None, device_count=None, platform=None)
    return info


class JsonlSink:
    """Appends one JSON object per line; writes the provenance record
    first so a stream is self-describing from byte 0."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh: Optional[io.TextIOBase] = open(path, "w")
        self.emit(provenance())

    def emit(self, record: Dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class MemorySink:
    """Collects records in a list — the test-suite sink."""

    def __init__(self):
        self.records: List[Dict] = []
        self.emit(provenance())

    def emit(self, record: Dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass

    def named(self, name: str) -> List[Dict]:
        return [r for r in self.records if r.get("name") == name]


class ConsoleSink:
    """Silent during the run; prints a compact metric summary at close so
    CLI output stays readable."""

    def __init__(self, registry: Registry):
        self._registry = registry

    def emit(self, record: Dict) -> None:
        pass

    def close(self) -> None:
        snap = self._registry.snapshot()
        if not snap:
            return
        print("-- telemetry summary --")
        for name, s in snap.items():
            if s["type"] == "histogram":
                if s["count"]:
                    print(f"  {name}: n={s['count']} mean="
                          f"{s['sum'] / s['count']:.6g} p50={s['p50']:.6g} "
                          f"p99={s['p99']:.6g} max={s['max']:.6g}")
            else:
                v = s["value"]
                if v is not None:
                    print(f"  {name}: {v:.6g}" if isinstance(v, float)
                          else f"  {name}: {v}")


class Telemetry:
    """Registry + sinks + optional profiler window.

    ``enabled=False`` short-circuits every hook to a no-op.  All sink
    writes happen under one lock: the driver's pump thread and the main
    thread report concurrently."""

    def __init__(self):
        self.registry = Registry()
        self.enabled = True
        self._sinks: List = []
        self._lock = threading.Lock()
        self._profile: Optional[ProfileWindow] = None

    # -- configuration ----------------------------------------------------

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def set_profile(self, window: Optional[ProfileWindow]) -> None:
        self._profile = window

    def reset(self) -> None:
        """Drop sinks, metrics, and the profile window."""
        with self._lock:
            for s in self._sinks:
                s.close()
            self._sinks = []
        if self._profile is not None:
            self._profile.stop()
            self._profile = None
        self.registry.reset()
        self.enabled = True

    # -- emission ---------------------------------------------------------

    def _emit(self, record: Dict) -> None:
        with self._lock:
            for s in self._sinks:
                s.emit(record)

    def event(self, name: str, **attrs) -> None:
        """Structured point-in-time event (record boundaries, comm-volume
        checkpoints, finished requests)."""
        if not self.enabled:
            return
        if self._sinks:
            self._emit({"kind": "event", "name": name, "ts": time.time(),
                        **attrs})

    def record_compile(self, kind: str, **attrs) -> None:
        """Called where a runtime builds a program (once per program key),
        beside its build counter, so ``compile.<kind>`` equals the count
        of programs built."""
        if not self.enabled:
            return
        self.registry.counter(f"compile.{kind}").inc()
        if self._sinks:
            self._emit({"kind": "compile", "name": f"compile.{kind}",
                        "ts": time.time(), **attrs})

    @contextlib.contextmanager
    def span(self, name: str, edges=DEFAULT_TIME_EDGES, **attrs):
        """Time a host-side region into ``registry.histogram(name)`` and
        (with sinks) the event stream.  Never adds a device sync: for a
        region that launches kernels this is the host's time to launch
        them.  Under an active ``--profile-dir`` window the region is
        also a ``torch.profiler.record_function`` range."""
        if not self.enabled:
            yield
            return
        prof = self._profile
        ann = prof.annotation(name) if prof is not None else None
        t0 = time.perf_counter()
        try:
            if ann is not None:
                with ann:
                    yield
            else:
                yield
        finally:
            dur = time.perf_counter() - t0
            self.registry.histogram(name, edges).observe(dur)
            if self._sinks:
                self._emit({"kind": "span", "name": name,
                            "ts": time.time(), "dur_s": dur, **attrs})
            if prof is not None:
                prof.tick()

    # -- shutdown ---------------------------------------------------------

    def finalize(self) -> None:
        """Emit a metric-snapshot line per registered metric, then close
        every sink (idempotent)."""
        if self._profile is not None:
            self._profile.stop()
            self._profile = None
        now = time.time()
        for name, snap in self.registry.snapshot().items():
            self._emit({"kind": "metric", "name": name, "ts": now, **snap})
        with self._lock:
            for s in self._sinks:
                s.close()
            self._sinks = []


_default = Telemetry()


def get() -> Telemetry:
    """The process-wide telemetry instance the runtimes report to."""
    return _default


def reset() -> None:
    """Reset the default instance to pristine (no sinks, empty registry,
    enabled)."""
    _default.reset()


def configure(jsonl: Optional[str] = None,
              memory: bool = False,
              console: bool = False,
              profile_dir: Optional[str] = None,
              profile_spans: int = 64,
              reset_first: bool = True) -> Telemetry:
    """One-call launcher setup: attach the requested sinks (and profiler
    window) to the default telemetry and return it.  Callers that passed
    ``memory=True`` find the MemorySink as the last sink."""
    tel = _default
    if reset_first:
        tel.reset()
    if jsonl:
        tel.add_sink(JsonlSink(jsonl))
    if console:
        tel.add_sink(ConsoleSink(tel.registry))
    if memory:
        tel.add_sink(MemorySink())
    if profile_dir:
        tel.set_profile(ProfileWindow(profile_dir, max_spans=profile_spans))
    return tel
