"""Async request driver over the continuous-batching runtime.

Port of ``repro/serving/driver.py``.

``ContinuousServer`` is a scheduler: give it a batch of requests and it
drains them.  Production traffic is not a batch — requests arrive on
their own clock, want their first token quickly even when someone else's
4k-token prompt is mid-prefill, and read tokens as a stream, not a final
array.  The driver adds that front-end:

  * **Request queue + admission control** — ``submit`` validates and
    queues; admission into the server is strictly FIFO (the property
    tests assert it), and an optional token budget
    (``max_queued_tokens``) pushes back on producers with
    :class:`QueueFull` instead of letting the queue grow unboundedly.
  * **Chunked prefill, interleaved** — each :meth:`tick` runs at most ONE
    prompt chunk (``prefill_chunk`` tokens, round-robin across every
    admission in progress) and ONE decode step for the in-flight set.
    A long prompt therefore stalls running streams for one chunk, not
    one prompt, bounding inter-token gaps — and short prompts admitted
    behind it finish their own (single-chunk) prefills between its
    chunks, bounding their TTFT.
  * **Streaming callbacks** — per-request ``on_token(uid, token)`` /
    ``on_finish(uid, result)``; :meth:`astream` adapts them to an asyncio
    generator (with :meth:`start`'s pump thread doing the device work, so
    an event loop never blocks on a decode step).
  * **Metrics** — per-request arrival/admission/first-token/finish
    timestamps and per-token times; :func:`summarize` folds them into
    p50/p99 TTFT, p99 inter-token gap, and tokens/sec.

The driver changes WHEN programs run, never WHAT they compute: per-request
tokens stay those of serving alone, one decode program serves a pool
geometry, and one prefill program a chunk length
(``tests/test_torch_driver.py`` holds the tokens, the admission order and
the page accounting to the JAX driver's on fixed streams and the
invariants on random ones, cancellations included).

Example::

    server = ContinuousServer(params, cfg, page_size=16, max_slots=8,
                              retain_pages=True)
    driver = RequestDriver(server, prefill_chunk=64)
    driver.submit(Request(0, prompt, max_new=32),
                  on_token=lambda uid, tok: print(tok))
    driver.drain()                       # or: driver.run(timed_arrivals)
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serving.batching import ContinuousServer, Request, Result

__all__ = ["QueueFull", "RequestMetrics", "RequestDriver",
           "poisson_arrivals", "summarize"]

#: bucket edges for the speculative burst-size histogram (tokens emitted
#: to one stream by one tick; bounded by the server's draft_k)
SPEC_BURST_EDGES = (1.5, 2.5, 3.5, 4.5, 6.5, 8.5, 16.5)


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the queued-token budget is exhausted —
    the backpressure signal; retry after tokens drain."""


@dataclasses.dataclass
class RequestMetrics:
    """Wall-clock accounting for one request (all times from the driver's
    ``clock``, typically ``time.perf_counter``)."""

    uid: Any
    arrival: float
    admitted: Optional[float] = None      # pages + slot reserved
    first_token: Optional[float] = None   # prefill done, token0 sampled
    finished: Optional[float] = None
    cancelled: bool = False
    tokens: Optional[np.ndarray] = None   # prompt + generated, on finish
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        return (None if self.first_token is None
                else self.first_token - self.arrival)

    @property
    def latency(self) -> Optional[float]:
        return None if self.finished is None else self.finished - self.arrival


@dataclasses.dataclass
class _Stream:
    """Driver-side state of one submitted request."""

    request: Request
    on_token: Optional[Callable[[Any, int], None]]
    on_finish: Optional[Callable[[Any, Optional[Result]], None]]
    emitted: int = 0  # generated tokens already delivered


def _cost(req: Request) -> int:
    return int(np.asarray(req.tokens).size) + int(req.max_new)


class RequestDriver:
    """Ticks a :class:`ContinuousServer` under live traffic.

    Parameters
    ----------
    server : the continuous-batching runtime to drive.  Construct it with
        ``retain_pages=True`` to keep shared-prompt pages warm across
        requests (the driver is the long-lived use case LRU retention is
        for).
    prefill_chunk : max tokens per prefill program call (None = each
        admission's whole uncached suffix in one call — the "whole-prompt
        prefill" baseline).  Ignored when the server's config forces the
        whole-prompt admit (``server.suffix_prefill`` False).
    max_queued_tokens : queued-token budget — the sum of ``S + max_new``
        over not-yet-admitted requests ``submit`` may hold before raising
        :class:`QueueFull`.  None = unbounded.  A request that alone
        exceeds the budget is still accepted on an empty queue (it could
        otherwise never be served).
    clock : timestamp source for metrics (injectable for tests).
    """

    def __init__(self, server: ContinuousServer, *,
                 prefill_chunk: Optional[int] = None,
                 max_queued_tokens: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 (or None)")
        self.server = server
        self.prefill_chunk = prefill_chunk
        self.max_queued_tokens = max_queued_tokens
        self._clock = clock
        self._lock = threading.RLock()
        self._pending: deque = deque()           # validated, not admitted
        self._queued_tokens = 0
        self._prefilling: deque = deque()        # _Prefill handles, RR order
        self._streams: Dict[Any, _Stream] = {}   # submitted, not finished
        self.metrics: Dict[Any, RequestMetrics] = {}
        self.admitted_order: List[Any] = []      # FIFO-fairness witness
        self._pump: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pump_error: Optional[BaseException] = None
        self._waiters: List[Callable[[BaseException], None]] = []

    # -- submission ------------------------------------------------------

    def submit(self, request: Request, *,
               on_token: Optional[Callable[[Any, int], None]] = None,
               on_finish: Optional[Callable[[Any, Optional[Result]], None]]
               = None) -> None:
        """Queue a request.  Raises :class:`QueueFull` when the token
        budget is exhausted, ``ValueError`` on invalid requests (empty
        prompt, missing sample seed, duplicate pending uid, oversized)."""
        with self._lock:
            cost = _cost(request)
            if (self.max_queued_tokens is not None and self._pending
                    and self._queued_tokens + cost > self.max_queued_tokens):
                raise QueueFull(
                    f"queued-token budget exhausted "
                    f"({self._queued_tokens}/{self.max_queued_tokens} held, "
                    f"request {request.uid!r} needs {cost})")
            # server.validate covers slots + prefills in progress; only the
            # driver-side queue is invisible to it
            request = self.server.validate(
                request, pending={r.uid for r in self._pending})
            self._pending.append(request)
            self._queued_tokens += cost
            self._streams[request.uid] = _Stream(request, on_token, on_finish)
            self.metrics[request.uid] = RequestMetrics(
                uid=request.uid, arrival=self._clock())

    def cancel(self, uid: Any) -> bool:
        """Drop a request wherever it is (queued / prefilling / decoding).
        Its pages and slot are released; no result is produced and
        ``on_finish(uid, None)`` fires.  False for unknown uids."""
        with self._lock:
            stream = self._streams.get(uid)
            if stream is None:
                return False
            for req in self._pending:
                if req.uid == uid:
                    self._pending.remove(req)
                    self._queued_tokens -= _cost(req)
                    break
            else:
                for pf in self._prefilling:
                    if pf.uid == uid:
                        self._prefilling.remove(pf)
                        break
                self.server.cancel(uid)
            rec = self.metrics[uid]
            rec.cancelled = True
            rec.finished = self._clock()
            tel = obs.get()
            if tel.enabled:
                tel.registry.counter("serve.requests_cancelled").inc()
            del self._streams[uid]
            if stream.on_finish is not None:
                stream.on_finish(uid, None)
            return True

    # -- the tick --------------------------------------------------------

    @property
    def has_work(self) -> bool:
        # taken under the lock: run() polls this from the caller's thread
        # while the pump thread mutates _pending/_prefilling (RLock, so
        # lock-held callers like drain() re-enter freely)
        with self._lock:
            return bool(self._pending or self._prefilling
                        or self.server.active_slots)

    def tick(self) -> bool:
        """One scheduling round: admit whatever fits (FIFO), run ONE
        prefill chunk (round-robin over admissions in progress), run ONE
        decode step for the in-flight set.  Returns False when there was
        nothing to do."""
        with self._lock:
            return self._tick()

    def _tick(self) -> bool:
        srv = self.server
        worked = False

        # 1. admission — strictly FIFO; a blocked head blocks everyone
        while self._pending:
            req = self._pending[0]
            if srv.suffix_prefill:
                pf = srv._begin_admit(req)
                if pf is None:
                    break
                self._prefilling.append(pf)
            else:
                if not srv._try_admit_legacy(req):
                    break
            self._pending.popleft()
            self._queued_tokens -= _cost(req)
            self.admitted_order.append(req.uid)
            self.metrics[req.uid].admitted = self._clock()
            if not srv.suffix_prefill:  # whole-prompt admit prefilled
                self._after_prefill(req.uid)
            worked = True

        # 2. one prefill chunk, round-robin across admissions in progress
        if self._prefilling:
            pf = self._prefilling.popleft()
            if srv._prefill_step(pf, self.prefill_chunk):
                self._after_prefill(pf.uid)
            else:
                self._prefilling.append(pf)
            worked = True

        # 3. one decode step for everyone in flight
        if srv.active_slots:
            retired = srv.step()  # server queue is empty: no hidden admits
            now = self._clock()
            for slot in srv._slots:
                if slot is not None and slot.uid in self._streams:
                    self._emit(slot.uid, slot.out, now)
            for uid in retired:
                if uid in self._streams:
                    result = srv._results[uid]
                    S = len(self._streams[uid].request.tokens)
                    self._emit(uid, result.tokens[S:], now)
                    self._finish(uid, result, now)
            worked = True
        return worked

    def _after_prefill(self, uid: Any) -> None:
        """Prefill completed this tick: token0 exists — stream it, and
        close out max_new==1 requests (already retired by the server)."""
        now = self._clock()
        srv = self.server
        for slot in srv._slots:
            if slot is not None and slot.uid == uid:
                self._emit(uid, slot.out, now)
                return
        result = srv._results.get(uid)  # max_new == 1: retired at admit
        if result is not None and uid in self._streams:
            S = result.tokens.size - self._streams[uid].request.max_new
            self._emit(uid, result.tokens[S:], now)
            self._finish(uid, result, now)

    def _emit(self, uid: Any, generated: Sequence[int], now: float) -> None:
        stream = self._streams[uid]
        rec = self.metrics[uid]
        burst = 0
        for tok in list(generated)[stream.emitted:]:
            if rec.first_token is None:
                rec.first_token = now
            rec.token_times.append(now)
            if stream.on_token is not None:
                stream.on_token(uid, int(tok))
            stream.emitted += 1
            burst += 1
        # speculative servers emit multi-token bursts (the accepted draft
        # prefix lands at once); the burst size IS the per-stream view of
        # the accept rate, so track its distribution
        if burst and getattr(self.server, "speculative", False):
            tel = obs.get()
            if tel.enabled:
                tel.registry.histogram(
                    "serve.spec_burst", SPEC_BURST_EDGES
                ).observe(burst)

    def _finish(self, uid: Any, result: Result, now: float) -> None:
        stream = self._streams.pop(uid)
        rec = self.metrics[uid]
        rec.finished = now
        rec.tokens = result.tokens
        self._observe(rec)
        if stream.on_finish is not None:
            stream.on_finish(uid, result)

    @staticmethod
    def _observe(rec: RequestMetrics) -> None:
        """Fold one finished request into the telemetry registry — the
        live view of what ``summarize`` computes offline."""
        tel = obs.get()
        if not tel.enabled:
            return
        reg = tel.registry
        reg.counter("serve.requests_finished").inc()
        reg.counter("serve.tokens_generated").inc(len(rec.token_times))
        if rec.ttft is not None:
            reg.histogram("serve.ttft_s").observe(rec.ttft)
        if rec.latency is not None:
            reg.histogram("serve.latency_s").observe(rec.latency)
        if len(rec.token_times) > 1:
            h = reg.histogram("serve.intertoken_s")
            for gap in np.diff(rec.token_times):
                h.observe(float(gap))
        tel.event("serve.request_finished", uid=str(rec.uid),
                  ttft_s=rec.ttft, latency_s=rec.latency,
                  tokens=len(rec.token_times))

    # -- synchronous serving loops --------------------------------------

    def drain(self) -> Dict[Any, RequestMetrics]:
        """Tick until every submitted request finished (or cancelled)."""
        while True:
            with self._lock:
                if not self.has_work:
                    return dict(self.metrics)
                worked = self._tick()
                if not worked and self._pending and not (
                        self._prefilling or self.server.active_slots):
                    raise RuntimeError(
                        f"driver stalled with {len(self._pending)} queued "
                        "requests on an idle server")

    def run(self, arrivals: Sequence) -> Dict[Any, RequestMetrics]:
        """Serve a timed workload: ``arrivals`` is a sequence of
        ``(delay_seconds, Request)`` pairs (or bare Requests, meaning
        arrive-at-0), submitted relative to the call's start time while
        ticking continuously.  Returns the metrics dict when everything
        submitted has finished."""
        sched: List[Tuple[float, Request]] = sorted(
            [(0.0, a) if isinstance(a, Request) else (float(a[0]), a[1])
             for a in arrivals], key=lambda p: p[0])
        i, t0 = 0, self._clock()
        while i < len(sched) or self.has_work:
            now = self._clock() - t0
            while i < len(sched) and sched[i][0] <= now:
                self.submit(sched[i][1])
                i += 1
            if not self.tick() and i < len(sched):
                time.sleep(min(1e-3, max(0.0, sched[i][0]
                                         - (self._clock() - t0))))
        with self._lock:
            return dict(self.metrics)

    # -- async front-end -------------------------------------------------

    def start(self) -> None:
        """Run the tick loop on a daemon pump thread (all device work
        happens there, on the server's device and on the stream current
        here when ``start`` is called; ``submit``/``cancel`` stay safe from
        any thread).  If a tick raises, the thread stops, every
        :meth:`astream` consumer gets the error, and :meth:`stop`
        re-raises it."""
        if self._pump is not None:
            return
        self._stop.clear()
        self._pump_error = None
        dev = self.server.device
        stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                  else None)

        def pump():
            ctx = (contextlib.nullcontext() if stream is None
                   else torch.cuda.stream(stream))
            try:
                with ctx:
                    while not self._stop.is_set():
                        if not self.tick():
                            time.sleep(1e-3)
            except BaseException as exc:  # noqa: BLE001 - handed on
                with self._lock:
                    self._pump_error = exc
                    waiters = list(self._waiters)
                for wake in waiters:
                    wake(exc)

        self._pump = threading.Thread(target=pump, name="serve-driver",
                                      daemon=True)
        self._pump.start()

    def stop(self) -> None:
        """Stop the pump thread and wait for it (and, on the card, for the
        work it launched), so the server's pools may be freed after.
        Re-raises what a tick raised on the thread."""
        if self._pump is None:
            return
        self._stop.set()
        self._pump.join()
        self._pump = None
        err, self._pump_error = self._pump_error, None
        if err is not None:
            raise RuntimeError("the driver's pump thread failed") from err
        if self.server.device.type == "cuda":
            torch.cuda.synchronize(self.server.device)

    async def astream(self, request: Request):
        """Async generator of ``request``'s generated tokens — the asyncio
        face of the callback API.  Requires :meth:`start` (or another
        thread ticking).  Propagates ``submit`` errors synchronously, and
        raises what a tick raised on the pump thread."""
        import asyncio

        loop = asyncio.get_running_loop()
        q: "asyncio.Queue" = asyncio.Queue()
        done = object()

        def wake(exc: BaseException) -> None:
            loop.call_soon_threadsafe(q.put_nowait, exc)

        with self._lock:
            if self._pump_error is not None:
                raise RuntimeError("the driver's pump thread failed") \
                    from self._pump_error
            self._waiters.append(wake)
        try:
            self.submit(
                request,
                on_token=lambda uid, tok:
                    loop.call_soon_threadsafe(q.put_nowait, tok),
                on_finish=lambda uid, res:
                    loop.call_soon_threadsafe(q.put_nowait, done),
            )
            while True:
                item = await q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise RuntimeError("the driver's pump thread "
                                       "failed") from item
                yield item
        finally:
            with self._lock:
                self._waiters.remove(wake)


# ---------------------------------------------------------------------------
# workloads + metric summaries
# ---------------------------------------------------------------------------


def poisson_arrivals(requests: Sequence[Request], rate: float, seed: int = 0
                     ) -> List[Tuple[float, Request]]:
    """Timestamp ``requests`` with exponential inter-arrival gaps (a
    Poisson process at ``rate`` requests/sec) for :meth:`RequestDriver.run`."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for req in requests:
        out.append((t, req))
        t += float(rng.exponential(1.0 / rate))
    return out


def summarize(metrics: Dict[Any, RequestMetrics]) -> Dict[str, Any]:
    """SLO view of a finished run: TTFT percentiles, inter-token-gap
    percentiles, end-to-end latency, and generated tokens/sec.

    Built on :func:`repro_torch.obs.percentile` so every degenerate shape is
    guarded in one place: an empty metrics dict, all-cancelled runs,
    zero-token requests (empty ``token_times``), and single-sample p99s
    all produce ``None``/0 fields instead of raising."""
    done = [m for m in metrics.values()
            if m.finished is not None and not m.cancelled]
    ttfts = [m.ttft for m in done]            # None-safe: obs drops holes
    gaps: List[float] = []
    for m in done:
        if len(m.token_times) > 1:            # zero/one-token requests
            gaps.extend(np.diff(m.token_times).tolist())
    lats = [m.latency for m in done]
    n_tok = sum(len(m.token_times) for m in done)
    span = (max(m.finished for m in done) - min(m.arrival for m in done)
            if done else 0.0)
    return {
        "requests": len(done),
        "cancelled": sum(m.cancelled for m in metrics.values()),
        "generated_tokens": n_tok,
        "tokens_per_s": n_tok / span if span > 0 else None,
        "ttft_p50_ms": obs.percentile_ms(ttfts, 50),
        "ttft_p99_ms": obs.percentile_ms(ttfts, 99),
        "intertoken_p99_ms": obs.percentile_ms(gaps, 99),
        "latency_p99_ms": obs.percentile_ms(lats, 99),
    }
