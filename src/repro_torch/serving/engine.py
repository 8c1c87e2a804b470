"""The scan serving engine: prefill once, then decode a static batch.

Port of ``repro/serving/engine.py`` without the mesh and stage-split
parts.  A request is a shape-uniform batch ``{"tokens": (B, S)}``, with
the frontend's ``"patches"`` (B, num_patches, D) or ``"frames"`` (B,
num_frames, D) where the config has one; the engine prefills the whole
prompt (``models.transformer.prefill``, whose
attention on the card is the hand-written flash-attention kernel and whose
rwkv6 time mix is the hand-written WKV kernel), then decodes
``max_new_tokens - 1`` more steps against the contiguous cache
(``decode_scan``), sampling each step.

Where the reference jits one prefill and one decode executable per shape
and keeps them in an executable cache, the port keeps a **program cache**
keyed the same way, ``(cfg, mode, B, S, max_new, capacity, greedy)``: a
program is the Python closure the engine runs for that shape, built once
and reused.  The counters (:func:`decode_trace_count`,
:func:`prefill_trace_count`) count programs built, one per shape, as the
reference's count traces.  Programs run eagerly, so every kernel launch
is counted by its wrapper; capturing the decode step as a CUDA graph is
later work.  Each program built is reported to ``repro_torch.obs`` as a
``compile`` event, and :func:`generate` times its prefill and its decode
in the ``serve.prefill`` and ``serve.decode`` spans.

Sampling is greedy (argmax) or, at ``temperature > 0``, a draw per
(request, step) from a ``torch.Generator`` seeded by
``prng.stream_seed(request seed, step)``, the continuous server's
scheme: a request's stream depends on its own seed and step alone, not on
its batch-mates or on ``max_new_tokens``.  Temperature sampling needs an
explicit seed, as the reference's needs an explicit key.

Serving modes:

  soup      uniform weight average of the population — single-model cost
            (the paper's "Averaged").
  member    member *i* unaveraged.
  ensemble  every member decodes, logits averaged (``averaging.balanced_mean``)
            before sampling — N× the cost.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import averaging
from repro_torch.core import population as pop
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.prng import fold_in, generator, stream_seed
from repro_torch.models import transformer as M

Tree = Any
Seeds = Optional[Union[int, Sequence[int]]]

MODES = ("soup", "member", "ensemble")


def internal_prefix(cfg: ModelConfig) -> int:
    """Positions the model prepends to the text: the vision patches, which
    the cache holds before the prompt and every decode position follows;
    0 for every other family."""
    return cfg.num_patches if cfg.frontend == "vision" else 0


# ---------------------------------------------------------------------------
# program counters + program cache
# ---------------------------------------------------------------------------

_DECODE_TRACES = [0]
_PREFILL_TRACES = [0]
_REFERENCE_TRACES = [0]

_PROGRAMS: Dict[Tuple, Tuple[Callable, Callable]] = {}


def reset_trace_counts() -> None:
    _DECODE_TRACES[0] = 0
    _PREFILL_TRACES[0] = 0
    _REFERENCE_TRACES[0] = 0


def decode_trace_count() -> int:
    """Decode programs built since the last reset (one per shape)."""
    return _DECODE_TRACES[0]


def prefill_trace_count() -> int:
    """Prefill programs built since the last reset (one per shape)."""
    return _PREFILL_TRACES[0]


def reference_trace_count() -> int:
    """Decode closures built by :func:`generate_reference` (one per call)."""
    return _REFERENCE_TRACES[0]


def executable_cache_size() -> int:
    return len(_PROGRAMS)


def clear_executable_cache() -> None:
    """Drop cached programs (tests use this to count builds from cold)."""
    _PROGRAMS.clear()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _request_seeds(seed: Seeds, batch: int,
                   temperature: float) -> Optional[List[int]]:
    """Per-request sample seeds: ``seed`` an int gives request b the seed
    ``fold_in(seed, b)``; a sequence gives each request its own.  Greedy
    decoding needs none; temperature sampling REQUIRES one — a silent
    default would make every sampled request stream identical."""
    if temperature <= 0.0:
        return None
    if seed is None:
        raise ValueError(
            "generate(temperature>0) requires an explicit seed: a default "
            "would make all sampled requests identical.  Pass seed=<int> or "
            "one seed per request (greedy decoding needs none).")
    if isinstance(seed, int):
        return [fold_in(seed, b) for b in range(batch)]
    seeds = [int(s) for s in seed]
    if len(seeds) != batch:
        raise ValueError(f"{len(seeds)} seeds for a batch of {batch}")
    return seeds


def _sample(logits: torch.Tensor, seeds: Optional[List[int]], step: int,
            temperature: float, greedy: bool) -> torch.Tensor:
    """Next-token ids (B,) int32 on the logits' device from last-position
    logits (B, 1, V).  Greedy is argmax (first index on ties, as
    ``jnp.argmax``); otherwise row b draws from softmax(logits /
    temperature) with a generator seeded by ``(seeds[b], step)``."""
    last = logits[:, -1]
    if greedy:
        return last.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    out = [torch.multinomial(probs[b], 1, generator=generator(
        stream_seed(seeds[b], step), last.device))
        for b in range(last.shape[0])]
    return torch.cat(out).to(torch.int32)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


def _ensemble_step(cfg: ModelConfig):
    """Population decode step: members looped over their slices of the
    stacked params and cache, logits averaged before sampling
    (balanced-tree mean, the soup's reduction)."""

    def step(params, cache, tokens, pos):
        n = pop.population_size(params)
        lgs = [M.decode_step(pop.member(params, i), cfg, tokens,
                             pop.member(cache, i), pos)[0] for i in range(n)]
        return averaging.balanced_mean(torch.stack(lgs)), cache

    return step


def _build_prefill(cfg: ModelConfig, ensemble: bool, capacity: int):
    _PREFILL_TRACES[0] += 1
    obs.get().record_compile("serve_prefill", capacity=capacity)

    def program(params, batch):
        if not ensemble:
            return M.prefill(params, cfg, batch, capacity=capacity)
        outs = [M.prefill(member, cfg, batch, capacity=capacity)
                for member in pop.unstack(params)]
        return (torch.stack([lg for lg, _ in outs]),
                pop.stack([c for _, c in outs]))

    return program


def _build_decode(cfg: ModelConfig, ensemble: bool, S: int, max_new: int,
                  greedy: bool):
    _DECODE_TRACES[0] += 1
    obs.get().record_compile("serve_decode", S=S, max_new=max_new)
    prefix = internal_prefix(cfg)
    step_fn = _ensemble_step(cfg) if ensemble else None

    def program(params, tokens, cache, first_logits, seeds, temperature):
        B = tokens.shape[0]
        if ensemble:
            first_logits = averaging.balanced_mean(first_logits)
        nxt = _sample(first_logits, seeds, 0, temperature, greedy)
        buf = torch.zeros((B, S + max_new), dtype=torch.int32,
                          device=tokens.device)
        buf[:, :S] = tokens
        buf[:, S] = nxt
        new_toks, cache = M.decode_scan(
            params, cfg, nxt, cache, prefix + S, max_new - 1,
            lambda lg, i: _sample(lg, seeds, i + 1, temperature, greedy),
            step_fn=step_fn)
        buf[:, S + 1:] = new_toks
        return buf, cache

    return program


def _programs(cfg: ModelConfig, ensemble: bool, B: int, S: int, max_new: int,
              capacity: int, greedy: bool):
    """Program-cache lookup: one (prefill, decode) pair per shape key."""
    key = ("serve", cfg, ensemble, B, S, max_new, capacity, greedy)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = (_build_prefill(cfg, ensemble, capacity),
                          _build_decode(cfg, ensemble, S, max_new, greedy))
    return _PROGRAMS[key]


def _place(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
           device: DeviceLike) -> Dict[str, torch.Tensor]:
    """The request's tokens, and its frontend's patches or frames, on
    ``device``; the params must live there.  On the card, a config whose
    shapes the kernels do not take is refused here, before the first
    prefill (``transformer.cuda_supported``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        reason = M.cuda_supported(cfg, "scan")
        if reason is not None:
            raise NotImplementedError(
                f"scan-engine serving of {cfg.name} on the card: {reason}")
    for x in pop.tree_leaves(params):
        if x.device != dev:
            raise ValueError(f"params must live on {dev}, found {x.device}")
    return {k: batch[k].to(dev) for k in ("tokens", "patches", "frames")
            if k in batch}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def averaged_params(trained: Any) -> Tree:
    """The uniform soup of a stacked population (or of an object with a
    ``.population`` attribute)."""
    population = getattr(trained, "population", trained)
    return averaging.uniform_soup(population)


def serving_params(trained: Any, mode: str = "soup", member: int = 0) -> Tree:
    """soup → averaged member; member → member *i* (views, no copy);
    ensemble → the stacked population as it is."""
    if mode not in MODES:
        raise ValueError(f"unknown serving mode {mode!r}; expected one of {MODES}")
    population = getattr(trained, "population", trained)
    if mode == "soup":
        return averaged_params(population)
    if mode == "member":
        return pop.member(population, member)
    return population


def generate(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
             max_new_tokens: int, temperature: float = 0.0,
             seed: Seeds = None, mode: str = "soup",
             device: DeviceLike = "cuda",
             timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """batch ``{"tokens": (B, S)}`` (with ``"patches"`` or ``"frames"``
    for a frontend) -> (B, S + max_new_tokens) int32 on
    ``device`` (the card unless the caller asks for the CPU; ``params``
    must live there).

    ``timings``, when given, receives ``prefill_s`` and ``decode_s``: the
    seconds of the prefill and of the decode, each timed to the device's
    end (one synchronization after each, which a call without
    ``timings`` does not make).

    ``mode="soup"``/``"member"`` serve ``params`` as a single model (the
    two differ only in how the caller picked the params); ``"ensemble"``
    expects a stacked (N, ...) population and averages member logits
    before sampling.  ``seed``: an int (request b draws from
    ``fold_in(seed, b)``) or one seed per request; needed when
    ``temperature > 0``."""
    if mode not in MODES:
        raise ValueError(f"unknown serving mode {mode!r}; expected one of {MODES}")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    batch = _place(params, cfg, batch, device)
    ensemble = mode == "ensemble"
    tokens = batch["tokens"]
    B, S = tokens.shape
    capacity = internal_prefix(cfg) + S + max_new_tokens
    greedy = temperature <= 0.0
    seeds = _request_seeds(seed, B, temperature)
    prefill_fn, decode_fn = _programs(cfg, ensemble, B, S, max_new_tokens,
                                      capacity, greedy)
    tel = obs.get()

    def mark(key, t0):
        if timings is None:
            return t0
        if tokens.device.type == "cuda":
            torch.cuda.synchronize(tokens.device)
        now = time.perf_counter()
        if key is not None:
            timings[key] = now - t0
        return now

    with torch.no_grad():
        t0 = mark(None, 0.0)
        with tel.span("serve.prefill", S=S, B=B):
            logits, cache = prefill_fn(params, batch)
        t0 = mark("prefill_s", t0)
        with tel.span("serve.decode", S=S, max_new=max_new_tokens):
            out, _ = decode_fn(params, tokens, cache, logits, seeds,
                               max(temperature, 1e-6))
        mark("decode_s", t0)
    return out


def generate_from_population(trained: Any, cfg: ModelConfig,
                             batch: Dict[str, torch.Tensor],
                             max_new_tokens: int, temperature: float = 0.0,
                             seed: Seeds = None, mode: str = "soup",
                             member: int = 0,
                             device: DeviceLike = "cuda") -> torch.Tensor:
    """Serve a trained population under a serving mode."""
    return generate(serving_params(trained, mode, member), cfg, batch,
                    max_new_tokens, temperature=temperature, seed=seed,
                    mode="ensemble" if mode == "ensemble" else "soup",
                    device=device)


def generate_reference(params: Tree, cfg: ModelConfig,
                       batch: Dict[str, torch.Tensor], max_new_tokens: int,
                       temperature: float = 0.0, seed: Seeds = None,
                       device: DeviceLike = "cuda") -> torch.Tensor:
    """The pre-engine serving loop, kept as the parity oracle of
    :func:`generate` (single-model modes): no program cache (each call
    counts once in :func:`reference_trace_count`, as each call of the
    reference re-traces), ``decode_step`` driven token by token with a list
    append per token.  Sampling uses the same per-request streams, so the
    two agree token for token."""
    batch = _place(params, cfg, batch, device)
    tokens = batch["tokens"]
    B, S = tokens.shape
    prefix = internal_prefix(cfg)
    capacity = prefix + S + max_new_tokens
    greedy = temperature <= 0.0
    seeds = _request_seeds(seed, B, temperature)
    temp = max(temperature, 1e-6)

    _REFERENCE_TRACES[0] += 1
    with torch.no_grad():
        logits, cache = M.prefill(params, cfg, batch, capacity=capacity)
        out = [tokens.to(torch.int32)]
        nxt = _sample(logits, seeds, 0, temp, greedy)
        for i in range(max_new_tokens):
            out.append(nxt[:, None])
            if i == max_new_tokens - 1:
                break
            logits, cache = M.decode_step(params, cfg, nxt[:, None], cache,
                                          prefix + S + i)
            nxt = _sample(logits, seeds, i + 1, temp, greedy)
    return torch.cat(out, dim=1)
