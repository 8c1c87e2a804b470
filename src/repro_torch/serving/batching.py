"""Continuous-batching serving runtime over a paged KV cache.

Port of ``repro/serving/batching.py`` (``ContinuousServer``).  A stream
of mixed-length requests is admitted
into ``max_slots`` serving slots; one decode step runs the whole in-flight
set per token, and finished slots retire.  KV lives in a shared pool of
fixed-size pages (``models.layers.paged_pools_init``), each slot holding a
page table of pool indices:

  * **prefix page reuse + suffix-only prefill** — full prompt pages are
    keyed by a chained content hash; a request whose prompt shares a
    page-aligned prefix with pages in the pool reuses them (refcount bump)
    and prefills only the uncached suffix;
  * **LRU page retention** (``retain_pages=True``) — hashed pages whose
    refcount drops to zero park on an LRU list and are evicted only under
    pool pressure;
  * **chunked prefill** (``prefill_chunk``) — each admission's prompt runs
    in chunks of at most that many tokens; ``serving.driver`` interleaves
    them with decode steps under live traffic;
  * **whole-prompt admit** — a config whose prefill numerics the paged
    attend cannot reproduce (``attn_impl != "naive"``) admits through
    ``models.transformer.prefill`` over the whole prompt (on the card the
    hand-written flash-attention kernel), then commits the pages under a
    write mask that skips shared prefix pages;
  * **speculative decoding** (``speculative=True``) — the soup drafts
    ``draft_k`` tokens, the ensemble verifies them in one step
    (``serving.speculative``);
  * **paged attention** — on the card every decode attend runs the
    hand-written Hopper kernel (``kernels.paged_attention``); on the CPU
    the plain version.  The pools' device decides; nothing switches the
    kernel off on the card.

Where the reference compiles a chunk program and a decode program and
donates the pools to them, the port runs the same steps as plain methods
that write the preallocated pool tensors **in place**.  It counts the
programs the reference would compile, one per program key (chunk length,
prompt length, pool geometry, draft length), in :func:`decode_trace_count`
and :func:`prefill_trace_count`, and reports each first build as a
``compile`` event to ``repro_torch.obs``, with the ``serve.decode_step``
span, the pool gauges and the speculative histograms.

Per-request contract (``tests/test_batching.py``): a request served
through a busy batch yields the tokens it would yield alone.  Greedy
decoding is held to the JAX package token for token.  With temperature
> 0 the port draws from a ``torch.Generator`` seeded per (request seed,
step), so a request's tokens do not depend on its batch-mates; JAX's
``fold_in``/``categorical`` stream cannot be reproduced in PyTorch.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import averaging
from repro_torch.core import population as pop
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.prng import stream_seed
from repro_torch.models import layers as L
from repro_torch.models import transformer as M
from repro_torch.serving import speculative as spec_mod
from repro_torch.serving.engine import MODES, averaged_params, serving_params

Tree = Any

#: pool page 0 is never allocated: inactive slots' page tables point here,
#: so their (masked, garbage) writes can't corrupt live pages.
SCRATCH_PAGE = 0

#: bucket edges for the per-step speculative rollback histogram (tokens
#: drafted but rejected across the in-flight set)
SPEC_ROLLBACK_EDGES = (0.5, 1.5, 2.5, 4.5, 8.5, 16.5, 32.5)


# ---------------------------------------------------------------------------
# program counters (the reference's trace counters)
# ---------------------------------------------------------------------------

_DECODE_TRACES = [0]
_PREFILL_TRACES = [0]
#: keys of the programs counted so far: the reference's jit-cache keys,
#: with the config by its hash.  Nothing is built or cached under them.
_COUNTED: set = set()


def reset_trace_counts() -> None:
    _DECODE_TRACES[0] = 0
    _PREFILL_TRACES[0] = 0


def decode_trace_count() -> int:
    """Decode programs built (one per pool geometry, mode, sampling and
    draft length), as the reference counts decode traces."""
    return _DECODE_TRACES[0]


def prefill_trace_count() -> int:
    """Prefill programs built: one per distinct chunk length, or per
    prompt length on the whole-prompt admit path."""
    return _PREFILL_TRACES[0]


def clear_executable_cache() -> None:
    """Forget the counted keys, as clearing the reference's jit caches
    would make it trace again."""
    _COUNTED.clear()


def _program(key, counter, kind: str, **attrs) -> None:
    """Count ``key``'s program the first time it runs and emit the
    ``compile`` event the reference's trace would.  Nothing is compiled:
    the port runs the steps eagerly, and the count and events only mirror
    the reference's trace counts."""
    if key in _COUNTED:
        return
    _COUNTED.add(key)
    counter[0] += 1
    obs.get().record_compile(kind, **attrs)


# ---------------------------------------------------------------------------
# requests / results / slots
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request in the stream.

    ``seed`` is required when the server samples (temperature > 0) and
    should be per-request, so identical prompts draw independent tokens."""

    uid: Any
    tokens: np.ndarray  # (S,) int32 prompt
    max_new: int
    seed: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Result:
    uid: Any
    tokens: np.ndarray  # (S + max_new,) int32: prompt + generated


@dataclasses.dataclass
class _Slot:
    uid: Any
    prompt: np.ndarray
    max_new: int
    seed: int
    pages: List[int]         # pool pages, prompt-order (shared and owned)
    total_pages: int         # worst-case pages this request can ever hold
    out: List[int]           # sampled tokens so far (out[-1] is pending)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def write_pos(self) -> int:
        # the pending token out[-1] lands at prompt_len + len(out) - 1
        return self.prompt_len + len(self.out) - 1

    @property
    def future_pages(self) -> int:
        return self.total_pages - len(self.pages)


def _total_pages(prompt_len: int, max_new: int, page_size: int) -> int:
    # tokens ever written to the pool: S prompt + (max_new - 1) decode
    # inputs (the final sampled token is never fed back)
    stored = prompt_len + max_new - 1
    return max(-(-stored // page_size), 1)


@dataclasses.dataclass
class _Prefill:
    """An admission in progress: pages and a slot are reserved, ``pos`` of
    the prompt's tokens are in the pool so far."""

    uid: Any
    prompt: np.ndarray
    max_new: int
    seed: int
    pages: List[int]         # ALL prompt pages (shared prefix + owned)
    total_pages: int
    pos: int                 # tokens already in the pool
    cached_tokens: int       # prefix tokens reused (their FLOPs skipped)
    slot_index: int          # reserved decode slot
    digests: List[bytes]     # chain hashes of the prompt's full pages

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def remaining(self) -> int:
        return self.prompt_len - self.pos


# ---------------------------------------------------------------------------
# host-side page pool: free list, refcounts, prefix hash index
# ---------------------------------------------------------------------------


class _PagePool:
    """Host bookkeeping for the device page pool.

    Pages are refcounted; ``prefix`` maps the chained content hash of a
    page-aligned prompt chunk to the page holding it.  With
    ``retain=True`` a hashed page whose refcount drops to zero parks on an
    LRU list instead of the free list, and ``alloc`` evicts the oldest
    parked page only once the free list is empty.  Every page is in
    exactly one of three states, so
    ``free_count + retained_count + len(refcount) == num_pages - 1``."""

    def __init__(self, num_pages: int, retain: bool = False):
        self.num_pages = num_pages
        self.retain = retain
        self.free: deque = deque(range(1, num_pages))  # page 0 = scratch
        self.refcount: Dict[int, int] = {}
        self.prefix: Dict[bytes, int] = {}
        self.hash_of: Dict[int, bytes] = {}
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # oldest first
        self.lru_hits = 0
        self.lru_evictions = 0

    @property
    def free_count(self) -> int:
        return len(self.free)

    @property
    def retained_count(self) -> int:
        return len(self.lru)

    @property
    def available_count(self) -> int:
        """Pages an admission may claim: free + evictable (parked)."""
        return len(self.free) + len(self.lru)

    @property
    def used_count(self) -> int:
        """Pages held by live slots/prefills (parked pages are not used)."""
        return len(self.refcount)

    def alloc(self) -> int:
        if self.free:
            page = self.free.popleft()
        else:  # pool pressure: evict the least-recently-parked page
            page, _ = self.lru.popitem(last=False)
            del self.prefix[self.hash_of.pop(page)]
            self.lru_evictions += 1
        self.refcount[page] = 1
        return page

    def share(self, digest: bytes) -> Optional[int]:
        page = self.prefix.get(digest)
        if page is None:
            return None
        if page in self.lru:  # revive: parked content is still valid KV
            del self.lru[page]
            self.refcount[page] = 1
            self.lru_hits += 1
        else:
            self.refcount[page] += 1
        return page

    def register(self, page: int, digest: bytes) -> None:
        self.prefix[digest] = page
        self.hash_of[page] = digest

    def release(self, page: int) -> None:
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            del self.refcount[page]
            if self.retain and page in self.hash_of:
                self.lru[page] = None  # park, most-recently-used last
                return
            digest = self.hash_of.pop(page, None)
            if digest is not None:
                self.prefix.pop(digest, None)
            self.free.append(page)


def _chain_hashes(tokens: np.ndarray, page_size: int) -> List[bytes]:
    """Chained per-page digests of the prompt's full pages: page j's key
    covers tokens[0 : (j+1)*page_size], so equal keys mean equal prefixes."""
    digests = []
    h = b""
    for j in range(tokens.shape[0] // page_size):
        chunk = np.ascontiguousarray(
            tokens[j * page_size:(j + 1) * page_size], dtype=np.int32)
        h = hashlib.sha1(h + chunk.tobytes()).digest()
        digests.append(h)
    return digests


# ---------------------------------------------------------------------------
# sampling (step index per SLOT)
# ---------------------------------------------------------------------------


def _sample_rows(last: torch.Tensor, seeds, steps, temperature: float,
                 greedy: bool) -> torch.Tensor:
    """Next-token ids (B,) int32 on the logits' device from last-position
    logits (B, V).

    Greedy is argmax (first index on ties, as ``jnp.argmax``).  Otherwise
    row b draws from softmax(logits / temperature) with a generator seeded
    by ``(seeds[b], steps[b])``."""
    if greedy:
        return last.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    out = []
    for b in range(last.shape[0]):
        gen = torch.Generator(device=last.device)
        gen.manual_seed(stream_seed(seeds[b], steps[b]))
        out.append(torch.multinomial(probs[b], 1, generator=gen))
    return torch.cat(out).to(torch.int32)


def _sample_steps(last: torch.Tensor, seeds, steps, temperature: float,
                  greedy: bool) -> np.ndarray:
    """:func:`_sample_rows` as int32 ids on the host."""
    return _sample_rows(last, seeds, steps, temperature,
                        greedy).cpu().numpy()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class ContinuousServer:
    """Continuous-batching server: queue in, per-request token streams out.

    Parameters
    ----------
    params : single-model params (modes ``soup``/``member``) or the stacked
        ``(N, ...)`` population (mode ``ensemble``), as tensors on
        ``device``; :meth:`from_trained` goes straight from a population.
    page_size : tokens per KV page.
    max_slots : in-flight request capacity (the decode step's batch).
    num_pages : pool size, shared by all slots (page 0 is scratch).
    max_pages_per_slot : page-table width = the longest context one slot
        can hold; defaults to the whole pool.
    temperature : stream-wide sampling temperature (0 = greedy).
    prefill_chunk : prefill every prompt in chunks of at most this many
        tokens (None = the whole suffix at once).
    retain_pages : park refcount-0 hashed pages on an LRU list (evicted
        under pressure) instead of freeing them.
    speculative / draft_k : draft ``draft_k`` tokens per decode call with
        the population soup and verify them in one ensemble step
        (``serving.speculative``): up to ``draft_k`` tokens a call, the
        plain path's tokens at float32 KV.  Needs the suffix-prefill path
        and a dense config.  In ``soup``/``member`` mode the model drafts
        for itself.
    kv_dtype : ``None`` stores KV pages in the param dtype; ``"int8"``
        quantizes every page with a per-(layer, page) float32 scale (the
        suffix-prefill path only).
    device : where pools live and steps run; ``"cuda"`` unless the caller
        asks for ``"cpu"``.  Without a card the default raises.
    """

    def __init__(self, params: Tree, cfg: ModelConfig, *,
                 mode: str = "soup", temperature: float = 0.0,
                 page_size: int = 16, max_slots: int = 4,
                 num_pages: int = 64,
                 max_pages_per_slot: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 retain_pages: bool = False,
                 speculative: bool = False, draft_k: int = 4,
                 kv_dtype: Optional[str] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            reason = M.cuda_supported(cfg, "continuous")
            if reason is not None:
                raise NotImplementedError(
                    f"continuous batching on the card: {reason}")
        if mode not in MODES:
            raise ValueError(
                f"unknown serving mode {mode!r}; expected one of {MODES}")
        reason = M.paged_decode_supported(cfg)
        if reason is not None:
            raise NotImplementedError(f"continuous batching: {reason}")
        if page_size < 1 or max_slots < 1 or num_pages < 2:
            raise ValueError("need page_size >= 1, max_slots >= 1, "
                             "num_pages >= 2 (page 0 is scratch)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 (or None)")
        if kv_dtype not in L.KV_DTYPES:
            raise ValueError(
                f"kv_dtype={kv_dtype!r}; expected one of {L.KV_DTYPES}")
        leaves = pop.tree_leaves(params)
        if any(x.device != self.device for x in leaves):
            raise ValueError(f"params must live on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ensemble = mode == "ensemble"
        self.temperature = float(temperature)
        self.greedy = self.temperature <= 0.0
        self.page_size = page_size
        self.max_slots = max_slots
        self.num_pages = num_pages
        self.max_pages = (max_pages_per_slot if max_pages_per_slot is not None
                          else num_pages - 1)
        self.prefill_chunk = prefill_chunk
        # suffix/chunk prefill needs paged numerics equal to the prefill's;
        # otherwise admissions take the whole-prompt path (no chunking,
        # prefix pages shared but their rows recomputed)
        self.suffix_prefill = M.paged_prefill_supported(cfg) is None
        self.kv_dtype = kv_dtype
        if kv_dtype is not None and not self.suffix_prefill:
            # the whole-prompt admit writes raw rows into the pools: it has
            # no quantization path
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r} needs the suffix-prefill path, "
                f"but {M.paged_prefill_supported(cfg)}")
        self.speculative = bool(speculative)
        self.draft_k = int(draft_k)
        if self.speculative:
            if self.draft_k < 1:
                raise ValueError(f"draft_k must be >= 1, got {draft_k}")
            reason = spec_mod.speculative_supported(cfg)
            if reason is not None:
                raise NotImplementedError(f"speculative decode: {reason}")

        # one pool pair per member in ensemble mode, each member's params
        # as views into the stacked population
        n = leaves[0].shape[0] if self.ensemble else 1
        self._members = ([pop.member(params, i) for i in range(n)]
                         if self.ensemble else [params])
        self._pools = [self._new_pools() for _ in range(n)]
        # the draft side: the soup drafts for the ensemble, a soup/member
        # server for itself; its pools share the verify pools' page tables
        self._draft_params = self._draft_pools = None
        if self.speculative:
            self._draft_params = (averaged_params(params) if self.ensemble
                                  else params)
            self._draft_pools = self._new_pools()

        self._pool = _PagePool(num_pages, retain=retain_pages)
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self._prefills: List[_Prefill] = []   # admission order
        self._reserved_slots: set = set()
        self._queue: deque = deque()
        self._results: Dict[Any, Result] = {}
        self._retired: List[Any] = []  # uids retired since step() began
        self.stats = {"admitted": 0, "retired": 0, "cancelled": 0,
                      "decode_steps": 0, "pages_allocated": 0,
                      "pages_shared": 0, "peak_pages_in_use": 0,
                      "prefill_tokens": 0, "prefix_tokens_reused": 0,
                      "lru_hits": 0, "lru_evictions": 0,
                      "spec_drafted": 0, "spec_accepted": 0}

    @classmethod
    def from_trained(cls, trained: Any, cfg: ModelConfig, *,
                     mode: str = "soup", member: int = 0, **kwargs):
        """Route a population through ``engine.serving_params`` into a
        server: soup/member servers hold one model, ensemble the stack."""
        return cls(serving_params(trained, mode, member), cfg, mode=mode,
                   **kwargs)

    def _new_pools(self):
        return L.paged_pools_init(self.cfg, self.num_pages, self.page_size,
                                  self.cfg.num_layers, kv_dtype=self.kv_dtype,
                                  device=self.device)

    def _geometry(self):
        return (hash(self.cfg), self.ensemble, self.max_slots,
                self.max_pages, self.page_size, self.num_pages, self.greedy,
                self.kv_dtype, self.device.type)

    def _last(self, lgs: List[torch.Tensor]) -> torch.Tensor:
        """The members' last-position logits (B, V), averaged with the
        balanced tree in ensemble mode."""
        if self.ensemble:
            return averaging.balanced_mean(torch.stack(lgs))[:, -1]
        return lgs[0][:, -1]

    # -- the device programs ---------------------------------------------

    def _chunk_program(self, tokens: torch.Tensor, pos0: int,
                       table: torch.Tensor) -> torch.Tensor:
        """One prompt chunk through ``M.prefill_paged`` for every member
        (and the draft model of a speculative server, into its own pools
        under the same table); returns the last position's
        (member-averaged) logits (1, V)."""
        T = int(tokens.shape[0])
        _program(("cont_chunk", T) + self._geometry() + (self.speculative,),
                 _PREFILL_TRACES, "cont_prefill_chunk", T=T)
        lgs = [M.prefill_paged(p, self.cfg, tokens, pos0, pools, table)[0]
               for p, pools in zip(self._members, self._pools)]
        if self.speculative:
            M.prefill_paged(self._draft_params, self.cfg, tokens, pos0,
                            self._draft_pools, table)
        return self._last(lgs)

    def _admit_program(self, tokens: torch.Tensor, pages: torch.Tensor,
                       write_mask: torch.Tensor) -> torch.Tensor:
        """The whole prompt (S,) through ``M.prefill`` for every member,
        then its K/V committed page by page into ``pages`` where
        ``write_mask`` is set (shared prefix pages already hold the same
        rows: same tokens, same params, same prefill).  Returns the last
        position's (member-averaged) logits (1, V)."""
        S, n_pages, ps = tokens.shape[0], pages.shape[0], self.page_size
        _program(("cont_admit", S, n_pages) + self._geometry(),
                 _PREFILL_TRACES, "cont_prefill_admit", S=S)
        sel = pages[write_mask]
        lgs = []
        for p, pools in zip(self._members, self._pools):
            lg, cache = M.prefill(p, self.cfg, {"tokens": tokens[None]},
                                  capacity=S)
            lgs.append(lg)
            for name in ("k", "v"):
                rows = cache["kv"][name][:, 0]          # (L, S, KV, hd)
                paged = rows.new_zeros((rows.shape[0], n_pages * ps)
                                       + rows.shape[2:])
                paged[:, :S] = rows
                paged = paged.reshape((rows.shape[0], n_pages, ps)
                                      + rows.shape[2:])
                pools[name][:, sel] = paged[:, write_mask]
        return self._last(lgs)

    def _decode_program(self, tokens: torch.Tensor, positions: torch.Tensor,
                        tables: torch.Tensor) -> torch.Tensor:
        """One decode token for every slot; returns (B, V) logits."""
        _program(("continuous",) + self._geometry() + (None,),
                 _DECODE_TRACES, "cont_decode", slots=int(tokens.shape[0]))
        return self._last([
            M.decode_step_paged(p, self.cfg, tokens, positions, pools,
                                tables)[0]
            for p, pools in zip(self._members, self._pools)])

    def _spec_program(self, *host_args):
        """The speculative decode call (``serving.speculative``)."""
        _program(("continuous",) + self._geometry() + (self.draft_k,),
                 _DECODE_TRACES, "cont_spec_decode", draft_k=self.draft_k)
        return spec_mod.speculative_step(
            self.cfg, self._members, self._pools, self._draft_params,
            self._draft_pools, *host_args, self.temperature, self.greedy,
            self.draft_k, self.device)

    # -- queue API -------------------------------------------------------

    def validate(self, request: Request, pending=()) -> Request:
        """Check a request the way :meth:`submit` would; returns it with
        its prompt normalized to a flat int32 array."""
        tokens = np.asarray(request.tokens, np.int32).reshape(-1)
        if tokens.shape[0] < 1 or request.max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        if not self.greedy and request.seed is None:
            raise ValueError(
                "sampling (temperature>0) requires a per-request seed")
        in_flight = {s.uid for s in self._slots if s is not None}
        in_flight |= {pf.uid for pf in self._prefills}
        if request.uid in in_flight or request.uid in pending or any(
                r.uid == request.uid for r in self._queue):
            raise ValueError(
                f"duplicate request uid {request.uid!r}: a request with "
                f"this uid is already queued or in flight")
        total = _total_pages(tokens.shape[0], request.max_new, self.page_size)
        if total > self.max_pages:
            raise ValueError(
                f"request {request.uid!r} needs {total} pages "
                f"(> max_pages_per_slot={self.max_pages})")
        if total > self.num_pages - 1:
            raise ValueError(
                f"request {request.uid!r} needs {total} pages "
                f"(> pool of {self.num_pages - 1} allocatable pages)")
        return dataclasses.replace(request, tokens=tokens)

    def submit(self, request: Request) -> None:
        self._queue.append(self.validate(request))

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    # -- scheduling ------------------------------------------------------

    def _reserved_pages(self) -> int:
        """Pages the in-flight slots/prefills may still demand."""
        live = sum(s.future_pages for s in self._slots if s is not None)
        live += sum(pf.total_pages - len(pf.pages) for pf in self._prefills)
        return live

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None and i not in self._reserved_slots:
                return i
        return None

    def _sync_pool_stats(self) -> None:
        self.stats["lru_hits"] = self._pool.lru_hits
        self.stats["lru_evictions"] = self._pool.lru_evictions
        self.stats["peak_pages_in_use"] = max(
            self.stats["peak_pages_in_use"], self._pool.used_count)
        tel = obs.get()
        if tel.enabled:
            reg = tel.registry
            reg.gauge("serve.pages_free").set(self._pool.free_count)
            reg.gauge("serve.pages_retained").set(self._pool.retained_count)
            reg.gauge("serve.pages_refcounted").set(self._pool.used_count)
            reg.gauge("serve.pages_peak").set(
                self.stats["peak_pages_in_use"])
            # prefix-dedup hit rate: the share of prompt tokens served from
            # cached prefix pages instead of a prefill
            seen = (self.stats["prefill_tokens"]
                    + self.stats["prefix_tokens_reused"])
            if seen:
                reg.gauge("serve.prefix_dedup_hit_rate").set(
                    self.stats["prefix_tokens_reused"] / seen)
                reg.gauge("serve.prefix_tokens_reused").set(
                    self.stats["prefix_tokens_reused"])

    def _begin_admit(self, req: Request) -> Optional[_Prefill]:
        """Reserve a slot and every prompt page for ``req`` — no compute.
        Shares the longest cached prefix run; returns None when no slot is
        free or the worst-case page reservation does not fit."""
        S = int(req.tokens.shape[0])
        n_prompt = max(-(-S // self.page_size), 1)
        total = _total_pages(S, req.max_new, self.page_size)
        slot_i = self._free_slot()
        if slot_i is None:
            return None

        digests = _chain_hashes(req.tokens, self.page_size)
        cached = 0
        while (cached < len(digests)
               and digests[cached] in self._pool.prefix):
            cached += 1
        # the suffix keeps >= 1 token: its last-position logits sample the
        # first output token
        cached = min(cached, (S - 1) // self.page_size)

        # reviving a parked prefix page consumes availability like an alloc
        revived = sum(1 for j in range(cached)
                      if self._pool.prefix[digests[j]] in self._pool.lru)
        need = (n_prompt - cached) + revived + (total - n_prompt)
        if self._pool.available_count - self._reserved_pages() < need:
            return None

        pages: List[int] = []
        for j in range(cached):
            pages.append(self._pool.share(digests[j]))
            self.stats["pages_shared"] += 1
        for j in range(cached, n_prompt):
            pages.append(self._pool.alloc())
            self.stats["pages_allocated"] += 1
        # freshly allocated pages are registered as sharable only once a
        # prefill chunk has written them (``_prefill_step``)
        self.stats["prefix_tokens_reused"] += cached * self.page_size
        self._sync_pool_stats()

        pf = _Prefill(uid=req.uid, prompt=req.tokens, max_new=req.max_new,
                      seed=0 if req.seed is None else int(req.seed),
                      pages=pages, total_pages=total,
                      pos=cached * self.page_size,
                      cached_tokens=cached * self.page_size,
                      slot_index=slot_i, digests=digests)
        self._reserved_slots.add(slot_i)
        self._prefills.append(pf)
        return pf

    def _prefill_step(self, pf: _Prefill, max_tokens: Optional[int] = None
                      ) -> bool:
        """Run ONE prompt chunk (at most ``max_tokens``; None = the whole
        remaining suffix).  On the final chunk, samples the first token
        and installs the slot (or retires it for ``max_new == 1``).
        Returns True when the prefill completed."""
        T = pf.remaining if max_tokens is None else min(max_tokens,
                                                        pf.remaining)
        chunk = pf.prompt[pf.pos:pf.pos + T]
        table = np.full((self.max_pages,), SCRATCH_PAGE, np.int32)
        table[:len(pf.pages)] = pf.pages
        last = self._chunk_program(
            torch.from_numpy(chunk).to(self.device), pf.pos,
            torch.from_numpy(table).to(self.device))
        token0 = int(_sample_steps(last, [pf.seed], [0], self.temperature,
                                   self.greedy)[0])
        written_before = pf.pos
        pf.pos += T
        self.stats["prefill_tokens"] += T
        # register the now-fully-written pages for prefix sharing, never
        # clobbering a digest already live on another page
        for j in range(written_before // self.page_size,
                       pf.pos // self.page_size):
            if j < len(pf.digests) and pf.digests[j] not in self._pool.prefix:
                self._pool.register(pf.pages[j], pf.digests[j])
        if pf.remaining:
            return False

        self._prefills.remove(pf)
        self._reserved_slots.discard(pf.slot_index)
        slot = _Slot(uid=pf.uid, prompt=pf.prompt, max_new=pf.max_new,
                     seed=pf.seed, pages=pf.pages, total_pages=pf.total_pages,
                     out=[token0])
        self.stats["admitted"] += 1
        if pf.max_new == 1:  # prefill-only request: retire immediately
            self._retire(slot)
        else:
            self._slots[pf.slot_index] = slot
        return True

    def _try_admit_legacy(self, req: Request) -> bool:
        """Whole-prompt admission through ``M.prefill`` and write-mask
        dedup: the path of a config ``M.paged_prefill_supported`` rejects
        (``attn_impl != "naive"``).  Shared prefix pages are skipped at
        write time, but their rows are still computed."""
        S = int(req.tokens.shape[0])
        n_prompt = max(-(-S // self.page_size), 1)
        total = _total_pages(S, req.max_new, self.page_size)
        slot_i = self._free_slot()
        if slot_i is None:
            return False

        digests = _chain_hashes(req.tokens, self.page_size)
        shared_pages = [self._pool.prefix.get(d) for d in digests]
        revived = sum(1 for p in shared_pages
                      if p is not None and p in self._pool.lru)
        new_now = n_prompt - sum(p is not None for p in shared_pages)
        need = new_now + revived + (total - n_prompt)
        if self._pool.available_count - self._reserved_pages() < need:
            return False

        pages: List[int] = []
        write_mask = np.ones((n_prompt,), bool)
        for j in range(n_prompt):
            page = self._pool.share(digests[j]) if j < len(digests) else None
            if page is not None:
                write_mask[j] = False
                self.stats["pages_shared"] += 1
            else:
                page = self._pool.alloc()
                self.stats["pages_allocated"] += 1
                if j < len(digests) and digests[j] not in self._pool.prefix:
                    self._pool.register(page, digests[j])
            pages.append(page)
        self._sync_pool_stats()
        self.stats["prefill_tokens"] += S

        seed = 0 if req.seed is None else int(req.seed)
        dev = self.device
        last = self._admit_program(
            torch.from_numpy(req.tokens).to(dev),
            torch.tensor(pages, dtype=torch.long, device=dev),
            torch.from_numpy(write_mask).to(dev))
        token0 = int(_sample_steps(last, [seed], [0], self.temperature,
                                   self.greedy)[0])
        slot = _Slot(uid=req.uid, prompt=req.tokens, max_new=req.max_new,
                     seed=seed, pages=pages, total_pages=total, out=[token0])
        self.stats["admitted"] += 1
        if req.max_new == 1:  # prefill-only request: retire immediately
            self._retire(slot)
            return True
        self._slots[slot_i] = slot
        return True

    def _try_admit(self, req: Request) -> bool:
        """Fully admit ``req``: its prefill runs to completion here, in
        ``prefill_chunk``-sized chunks if set (never interleaved with
        decode; the driver interleaves)."""
        if not self.suffix_prefill:
            return self._try_admit_legacy(req)
        pf = self._begin_admit(req)
        if pf is None:
            return False
        while not self._prefill_step(pf, self.prefill_chunk):
            pass
        return True

    def cancel(self, uid: Any) -> bool:
        """Drop a request wherever it is — queued, prefilling, or decoding
        — releasing its pages and slot.  Returns False for unknown uids."""
        for r in self._queue:
            if r.uid == uid:
                self._queue.remove(r)
                self.stats["cancelled"] += 1
                return True
        for pf in self._prefills:
            if pf.uid == uid:
                for page in pf.pages:
                    self._pool.release(page)
                self._prefills.remove(pf)
                self._reserved_slots.discard(pf.slot_index)
                self.stats["cancelled"] += 1
                return True
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.uid == uid:
                for page in slot.pages:
                    self._pool.release(page)
                self._slots[i] = None
                self.stats["cancelled"] += 1
                return True
        return False

    def _admit(self) -> None:
        while self._queue and self._free_slot() is not None:
            if not self._try_admit(self._queue[0]):
                break  # head-of-line blocks until pages free up
            self._queue.popleft()

    def _grow(self, slot: _Slot, extra: int = 0) -> None:
        """Lazy page growth: allocate the write page(s) just before they
        are needed (``extra`` covers a speculative step's lookahead,
        bounded by the budget, so never past the admission-time worst
        case).  Cannot fail — admission reserved that worst case."""
        need_pages = (slot.write_pos + extra) // self.page_size + 1
        while len(slot.pages) < need_pages:
            slot.pages.append(self._pool.alloc())
            self.stats["pages_allocated"] += 1
        self._sync_pool_stats()

    def _shrink(self, slot: _Slot) -> None:
        """Roll a speculative step's page-table cursor back: release the
        trailing pages past the (possibly rolled-back) write position.
        Trailing decode pages are never chain-hash registered, so release
        frees them, and the pool's free / retained / refcounted partition
        survives every rollback."""
        keep = slot.write_pos // self.page_size + 1
        while len(slot.pages) > keep:
            self._pool.release(slot.pages.pop())
        self._sync_pool_stats()

    def _retire(self, slot: _Slot) -> None:
        for page in slot.pages:
            self._pool.release(page)
        self.stats["retired"] += 1
        self._retired.append(slot.uid)
        self._results[slot.uid] = Result(
            uid=slot.uid,
            tokens=np.concatenate([slot.prompt,
                                   np.asarray(slot.out, np.int32)]))

    # -- the decode step -------------------------------------------------

    def step(self) -> List[Any]:
        """Admit what fits, run ONE decode step for the in-flight set,
        retire whatever finished.  Returns the uids retired in this step,
        a uid that a finished request used before among them."""
        self._retired = []
        self._admit()
        if self.active_slots == 0:
            return list(self._retired)

        B, Pmax = self.max_slots, self.max_pages
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        steps = np.zeros((B,), np.int32)
        budgets = np.full((B,), np.iinfo(np.int32).max, np.int32)
        active = np.zeros((B,), bool)
        seeds = np.zeros((B,), np.int64)
        # inactive slots read and write scratch page 0 at offset 0
        tables = np.full((B, Pmax), SCRATCH_PAGE, np.int32)
        n_spec = np.zeros((B,), np.int32)  # proposals per slot this call
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if self.speculative:
                n_spec[i] = max(min(self.draft_k,
                                    slot.max_new - len(slot.out)), 1)
            self._grow(slot, extra=max(int(n_spec[i]) - 1, 0))
            tokens[i] = slot.out[-1]
            positions[i] = slot.write_pos
            steps[i] = len(slot.out)
            budgets[i] = slot.max_new
            active[i] = True
            seeds[i] = slot.seed
            tables[i, :len(slot.pages)] = slot.pages

        dev = self.device
        tel = obs.get()
        with tel.span("serve.decode_step", slots=self.active_slots):
            if self.speculative:
                sampled, counts, done = self._spec_program(
                    tokens, positions, steps, budgets, active, tables, seeds)
            else:
                logits = self._decode_program(
                    torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(positions).to(dev),
                    torch.from_numpy(tables).to(dev))
                sampled = _sample_steps(logits, seeds, steps,
                                        self.temperature, self.greedy)
                sampled = np.where(active, sampled, 0)
                done = active & (steps + 1 >= budgets)
        self.stats["decode_steps"] += 1
        if tel.enabled:
            tel.registry.counter("serve.decode_steps").inc()
            tel.registry.histogram(
                "serve.slot_occupancy", obs.RATIO_EDGES
            ).observe(self.active_slots / self.max_slots)

        drafted = accepted = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if self.speculative:
                m = int(counts[i])
                slot.out.extend(int(t) for t in sampled[i, :m])
                drafted += int(n_spec[i]) - 1
                accepted += m - 1
                if not done[i]:
                    # roll the page-table cursor back over rejected tokens
                    self._shrink(slot)
            else:
                slot.out.append(int(sampled[i]))
            if done[i]:
                self._retire(slot)
                self._slots[i] = None
        if self.speculative:
            self.stats["spec_drafted"] += drafted
            self.stats["spec_accepted"] += accepted
            if tel.enabled:
                reg = tel.registry
                reg.counter("serve.spec_drafted").inc(drafted)
                reg.counter("serve.spec_accepted").inc(accepted)
                if drafted:
                    reg.histogram(
                        "serve.spec_accept_ratio", obs.RATIO_EDGES
                    ).observe(accepted / drafted)
                reg.histogram(
                    "serve.spec_rollback", SPEC_ROLLBACK_EDGES
                ).observe(drafted - accepted)
        return list(self._retired)

    def run(self, requests: Optional[List[Request]] = None
            ) -> Dict[Any, Result]:
        """Submit ``requests`` (if given) and drain queue + slots to
        completion.  Returns every result produced so far, keyed by uid."""
        for req in requests or []:
            self.submit(req)
        while self._queue or self.active_slots:
            if (not self.step() and self.active_slots == 0
                    and self._queue):
                raise RuntimeError(
                    f"scheduler stalled with {len(self._queue)} queued "
                    f"requests and {self._pool.available_count} "
                    f"available pages")
        return dict(self._results)
