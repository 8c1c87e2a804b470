"""The scan serving engine: prefill once, then decode a static batch.

Port of ``repro/serving/engine.py``.  A request is a shape-uniform batch ``{"tokens": (B, S)}``, with
the frontend's ``"patches"`` (B, num_patches, D) or ``"frames"`` (B,
num_frames, D) where the config has one; the engine prefills the whole
prompt (``models.transformer.prefill``, whose
attention on the card is the hand-written flash-attention kernel and whose
rwkv6 time mix is the hand-written WKV kernel), then decodes
``max_new_tokens - 1`` more steps against the contiguous cache
(``decode_scan``), sampling each step.

Where the reference jits one prefill and one decode executable per shape
and keeps them in an executable cache, the port keeps a **program cache**
keyed the same way, ``(cfg, mode, B, S, max_new, capacity, greedy,
stages, data size)``: a
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

A trained population comes from either training engine: the ensemble
engine's :class:`repro_torch.train.loop.TrainResult` holds a rank's
block of members (or of their shards and stages), so
:func:`serving_params` first gathers the whole population over the mesh
it came from, to every rank, as the reference gathers every leaf.

**Meshes** (``generate(mesh=)``, the serve CLI's ``--mesh data`` and
``--pp-stages``; ``launch/mesh.py``'s :class:`ServeMesh`):

  data  every rank holds the whole model (the whole population for
        ``ensemble``) and serves its rows of the request when the batch
        divides over the data group (``sharding.rules.batch_pspecs``),
        the whole batch otherwise; the output is all-gathered in global
        order.  Sample seeds come from the global request index, so a
        request's stream does not depend on its rank.  An MoE config with
        ``moe_impl="global"`` routes all of a call's tokens as one
        capacity group, so its batch is never split
        (:func:`data_layout`).
  pipe  S stages, one a rank: rank s holds ``params["blocks"]`` rows
        [s·L/S, (s+1)·L/S) and their slice of the cache; the other leaves
        on every rank.  In prefill and each decode step stage 0 embeds,
        each stage runs its layers once (``models.transformer``'s
        ``prefill_blocks`` / ``decode_blocks``, the unstaged engine's
        per-layer function) and sends the activation to the next, the
        last stage computes the logits and samples, and its ids are
        broadcast over the stages, so every stage ends the step holding
        the same token and the tokens are the unstaged engine's bitwise.
        The reference's refusals: a pipe-only mesh, no ``ensemble``,
        ``L % S == 0``, ``staged_decode_supported``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import averaging
from repro_torch.core import population as pop
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.prng import fold_in, generator, stream_seed
from repro_torch.models import transformer as M
from repro_torch.sharding import rules

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


# ---------------------------------------------------------------------------
# stage-split programs (a pipe mesh)
# ---------------------------------------------------------------------------


def _hop_in(mesh, like_shape, dtype, device) -> torch.Tensor:
    """Stage s > 0's input: the previous stage's activation."""
    x = torch.empty(like_shape, dtype=dtype, device=device)
    dist.recv(x, src=mesh.prev_rank, group=mesh.pipe.group)
    return x


def _hop_out(mesh, y: torch.Tensor, dtype) -> None:
    """Hand this stage's activation to the next stage (if any)."""
    if mesh.next_rank is None:
        return
    if y.dtype != dtype:
        raise ValueError(f"a stage's output is {y.dtype}, the next stage "
                         f"expects {dtype}")
    dist.send(y.contiguous(), dst=mesh.next_rank, group=mesh.pipe.group)


def _staged_sample(mesh, logits, B: int, seeds, step: int, temperature,
                   greedy: bool, device) -> torch.Tensor:
    """The last stage samples (B,) int32 ids from its logits, as
    :func:`_sample` does, and broadcasts them over the stages."""
    last = mesh.num_stages - 1
    ids = (_sample(logits, seeds, step, temperature, greedy)
           if mesh.stage == last
           else torch.empty((B,), dtype=torch.int32, device=device))
    dist.broadcast(ids, src=mesh.global_rank(mesh.pipe, last),
                   group=mesh.pipe.group)
    return ids


def _build_staged(cfg: ModelConfig, stages: int, B: int, S: int,
                  max_new: int, capacity: int, greedy: bool):
    """The staged (prefill, decode) pair for one shape, each called with
    this rank's stage params and its ``mesh``."""
    local_cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers // stages)
    _PREFILL_TRACES[0] += 1
    obs.get().record_compile("serve_prefill_staged", stages=stages,
                             capacity=capacity)
    _DECODE_TRACES[0] += 1
    obs.get().record_compile("serve_decode_staged", stages=stages, S=S,
                             max_new=max_new)

    def stage(mesh, params, x_fn, blocks_fn, shape, dev):
        dtype = params["embed"]["tok"].dtype
        h = x_fn() if mesh.stage == 0 else _hop_in(mesh, shape, dtype, dev)
        y = blocks_fn(h)
        _hop_out(mesh, y, dtype)
        return y

    def prefill(params, batch, mesh):
        tokens = batch["tokens"]
        dev = tokens.device
        cache = M.init_cache(local_cfg, B, capacity, device=dev)

        def blocks(h):
            return M.prefill_blocks(params["blocks"], local_cfg, h, cache)[0]

        y = stage(mesh, params, lambda: M.prefill_embed(params, cfg, batch),
                  blocks, (B, S, cfg.d_model), dev)
        last = mesh.stage == mesh.num_stages - 1
        return (M.lm_logits(params, cfg, y[:, -1:]) if last else None), cache

    def decode(params, tokens, cache, first_logits, seeds, temperature,
               mesh):
        dev = tokens.device
        last = mesh.stage == mesh.num_stages - 1

        def step_fn(p, c, t, pos):
            def blocks(h):
                return M.decode_blocks(p["blocks"], local_cfg, h, c, pos)[0]

            y = stage(mesh, p, lambda: M.decode_embed(p, cfg, t, pos),
                      blocks, (B, 1, cfg.d_model), dev)
            return (M.lm_logits(p, cfg, y) if last else None), c

        def next_fn(lg, i):
            return _staged_sample(mesh, lg, B, seeds, i, temperature, greedy,
                                  dev)

        nxt = next_fn(first_logits, 0)
        buf = torch.zeros((B, S + max_new), dtype=torch.int32, device=dev)
        buf[:, :S] = tokens
        buf[:, S] = nxt
        new_toks, cache = M.decode_scan(
            params, cfg, nxt, cache, S, max_new - 1,
            lambda lg, i: next_fn(lg, i + 1), step_fn=step_fn)
        buf[:, S + 1:] = new_toks
        return buf, cache

    return prefill, decode


def _programs(cfg: ModelConfig, ensemble: bool, B: int, S: int, max_new: int,
              capacity: int, greedy: bool, stages: int = 1, data: int = 1):
    """Program-cache lookup: one (prefill, decode) pair per shape key,
    the stage count and the data size part of it.  Staged programs take
    the mesh as their last argument."""
    key = ("serve", cfg, ensemble, B, S, max_new, capacity, greedy, stages,
           data)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = (
            _build_staged(cfg, stages, B, S, max_new, capacity, greedy)
            if stages > 1 else
            (_build_prefill(cfg, ensemble, capacity),
             _build_decode(cfg, ensemble, S, max_new, greedy)))
    return _PROGRAMS[key]


def _mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(getattr(mesh, "axis_names", ())) if mesh is not None else ()


def check_staged_request(cfg: ModelConfig, mode: str, mesh) -> None:
    """Validate a pipe-mesh request (stage count >= 2), with the
    reference's messages; raises on every rank alike, before any
    exchange."""
    extra = [a for a in _mesh_axes(mesh) if a != "pipe" and mesh.shape[a] > 1]
    if extra:
        raise ValueError(
            f"stage-split serving wants a pipe-only mesh; axes {extra} have "
            "size > 1 (shard the batch on a separate data mesh instead)"
        )
    if mode == "ensemble":
        raise ValueError(
            "mode='ensemble' is not supported with stage-split decode: the "
            "vmapped population step and the pipe hops do not compose; "
            "serve the soup or a member on the pipe mesh"
        )
    reason = M.staged_decode_supported(cfg)
    if reason is not None:
        raise NotImplementedError(f"staged decode: {reason}")
    stages = mesh.shape["pipe"]
    if cfg.num_layers % stages:
        raise ValueError(
            f"num_layers={cfg.num_layers} does not split evenly over "
            f"{stages} pipeline stages"
        )


def stage_params(params: Tree, cfg: ModelConfig, mesh) -> Tree:
    """This rank's stage of ``params``: the ``blocks`` leaves' rows
    [s·L/S, (s+1)·L/S) (views; leaves that already hold L/S rows are
    taken as they are), every other leaf as it is."""
    stages, s = mesh.num_stages, mesh.stage
    n = cfg.num_layers // stages

    def rows(x):
        if x.shape[0] == cfg.num_layers:
            return x[s * n:(s + 1) * n]
        if x.shape[0] == n:
            return x
        raise ValueError(f"a blocks leaf of {x.shape[0]} layers is neither "
                         f"the model's {cfg.num_layers} nor a stage's {n}")

    return {**params, "blocks": pop.tree_map(rows, params["blocks"])}


def data_layout(cfg: ModelConfig, mesh, batch_size: int) -> str:
    """How a request of ``batch_size`` rows lies on a serving mesh:
    ``"split"`` (each data rank serves its rows, as
    ``rules.batch_pspecs`` splits the batch) or ``"replicated"`` (every
    rank serves the whole batch: the batch does not divide, the mesh has
    no data axis, or an MoE config routes with ``moe_impl="global"``,
    where the capacity group is the whole call and splitting rows would
    change which tokens are dropped)."""
    if cfg.moe and cfg.moe_impl == "global":
        return "replicated"
    spec = rules.batch_pspecs(cfg, mesh, batch_size)["tokens"]
    return "split" if spec[0] is not None else "replicated"


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


def _whole_population(trained: Any) -> Tree:
    """The whole stacked population of ``trained`` (a population tree, or
    an object with ``.population``).  A ``TrainResult`` of the ensemble
    engine holds this rank's block of members (or of their shards and
    stages): it is gathered over the mesh it came from to every rank, a
    collective that every rank of that mesh must call (at world 1 the
    block itself)."""
    population = getattr(trained, "population", trained)
    mesh = getattr(trained, "mesh", None)
    if mesh is None:
        return population
    shard_dims = getattr(trained, "shard_dims", None)
    stage_split = getattr(trained, "stage_split", None)
    split = [getattr(mesh, "pop", mesh).world > 1,
             shard_dims is not None and getattr(mesh, "model", None)
             is not None and mesh.model.world > 1,
             stage_split is not None and getattr(mesh, "pipe", None)
             is not None and mesh.pipe.world > 1]
    if any(split) and not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "this TrainResult holds one rank's block of the population and "
            "its process group is gone: gather it with "
            "repro_torch.core.population.gather_population over its mesh, "
            "on every rank, before the mesh closes, and serve that")
    return pop.gather_population(population, mesh, dst=None,
                                 shard_dims=shard_dims,
                                 stage_split=stage_split)


def averaged_params(trained: Any) -> Tree:
    """The uniform soup of a stacked population, or of a ``TrainResult``
    of either training engine (the whole population, gathered as
    :func:`serving_params` gathers it)."""
    return averaging.uniform_soup(_whole_population(trained))


def serving_params(trained: Any, mode: str = "soup", member: int = 0) -> Tree:
    """soup → averaged member; member → member *i* (views, no copy);
    ensemble → the stacked population as it is.  ``trained`` is a stacked
    population or a ``TrainResult`` of either training engine; an
    ensemble-engine result on a world > 1 is gathered whole over its mesh
    first, to every rank (so every rank of that mesh must call this), and
    raises a ValueError naming ``gather_population`` when its process
    group is gone: a rank's block is never served as the population."""
    if mode not in MODES:
        raise ValueError(f"unknown serving mode {mode!r}; expected one of {MODES}")
    population = _whole_population(trained)
    if mode == "soup":
        return averaging.uniform_soup(population)
    if mode == "member":
        return pop.member(population, member)
    return population


def generate(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
             max_new_tokens: int, temperature: float = 0.0,
             seed: Seeds = None, mode: str = "soup",
             device: DeviceLike = "cuda",
             timings: Optional[Dict[str, float]] = None,
             mesh=None) -> torch.Tensor:
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
    ``temperature > 0``.

    ``mesh`` (a ``launch.mesh.ServeMesh``; every rank of it calls
    ``generate`` with the same request) serves on ``mesh.device``: a
    ``data`` mesh splits the rows (:func:`data_layout`) and returns the
    whole output on every rank; a ``pipe`` mesh of S > 1 stages runs this
    rank's stage of ``params`` (whole params, or already a stage's
    :func:`stage_params`) and returns the tokens on every stage."""
    if mode not in MODES:
        raise ValueError(f"unknown serving mode {mode!r}; expected one of {MODES}")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    stages = mesh.shape["pipe"] if "pipe" in _mesh_axes(mesh) else 1
    if stages > 1:
        check_staged_request(cfg, mode, mesh)
        params = stage_params(params, cfg, mesh)
    if mesh is not None:
        device = mesh.device
    batch = _place(params, cfg, batch, device)
    ensemble = mode == "ensemble"
    tokens = batch["tokens"]
    B, S = tokens.shape
    capacity = internal_prefix(cfg) + S + max_new_tokens
    greedy = temperature <= 0.0
    seeds = _request_seeds(seed, B, temperature)
    data = mesh.data.world if mesh is not None and stages == 1 else 1
    split = data > 1 and data_layout(cfg, mesh, B) == "split"
    prefill_fn, decode_fn = _programs(cfg, ensemble, B, S, max_new_tokens,
                                      capacity, greedy, stages, data)
    extra = (mesh,) if stages > 1 else ()
    if split:  # this rank's rows; seeds from the global request index
        n = B // data
        rows = slice(mesh.data.rank * n, (mesh.data.rank + 1) * n)
        batch = {k: v[rows] for k, v in batch.items()}
        tokens = batch["tokens"]
        seeds = seeds[rows] if seeds is not None else None
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
            logits, cache = prefill_fn(params, batch, *extra)
        t0 = mark("prefill_s", t0)
        with tel.span("serve.decode", S=S, max_new=max_new_tokens):
            out, _ = decode_fn(params, tokens, cache, logits, seeds,
                               max(temperature, 1e-6), *extra)
        mark("decode_s", t0)
    if split:  # every rank's rows, in global order
        parts = [torch.empty_like(out) for _ in range(data)]
        dist.all_gather(parts, out, group=mesh.data.group)
        out = torch.cat(parts)
    return out


def generate_from_population(trained: Any, cfg: ModelConfig,
                             batch: Dict[str, torch.Tensor],
                             max_new_tokens: int, temperature: float = 0.0,
                             seed: Seeds = None, mode: str = "soup",
                             member: int = 0,
                             device: DeviceLike = "cuda",
                             mesh=None) -> torch.Tensor:
    """Serve a trained population (either engine) under a serving mode,
    on ``mesh`` when given."""
    return generate(serving_params(trained, mode, member), cfg, batch,
                    max_new_tokens, temperature=temperature, seed=seed,
                    mode="ensemble" if mode == "ensemble" else "soup",
                    device=device, mesh=mesh)


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
