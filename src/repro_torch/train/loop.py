"""Population training loop (paper Alg. 1).

Port of ``repro/train/loop.py``: ``engine="vmap"`` is the reference loop
below, ``engine="shard_map"`` the ensemble engine over the ranks of a
``torch.distributed`` group (:mod:`repro_torch.train.engine`).  Each
step: (1) an independent optimizer step per member on its own data
stream, then (2) the configured mixing op (WASH shuffle / PAPA EMA /
PAPA-all average / none) on the stacked population.

Where the reference vmaps ``value_and_grad`` over the stacked members,
the port loops over them: member m's parameters are views ``leaf[m]`` of
the stacked leaves, so one member's activations and gradients exist at a
time, and the optimizer and the shuffle write the stacked ``(N, ...)``
leaves in place.  Telemetry (``repro_torch.obs``) times each step's
member updates in the ``train.step`` span, mirrors the exact float64 comm
total in the ``train.comm_scalars`` counter and one ``train.comm_volume``
event per mixing step (what ``tools/check_metrics_schema.py
--require-comm`` replays), and sets the loss, steps/s and record gauges.
The loop works for any model: the caller supplies
``init_fn(seed) -> params``, ``loss_fn(params, batch) -> scalar`` and
``data_fn(member, step, seed) -> batch``.  Seeds play the role of the
reference's keys (``core.prng``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import population as pop
from repro_torch.core.consensus import avg_distance_to_consensus
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.layer_index import infer_layer_ids, total_layers
from repro_torch.core.mixing import (MixingConfig, mix_once, mixing_due,
                                     static_mix_comm)
from repro_torch.core.prng import fold_in, step_seed
from repro_torch.optim import cosine_lr, make_optimizer

Tree = Any

#: the phases of a step that :attr:`TrainResult.phase_ms` times
PHASES = ("fwd_bwd", "opt", "mix")


@dataclasses.dataclass
class TrainResult:
    population: Tree
    opt_state: Tree
    history: Dict[str, List[float]]
    comm_scalars: float  # total scalars sent per member over training
    #: per step, milliseconds in forward+backward (all members), the
    #: optimizer updates and the mixing op: CUDA events on the card, the
    #: host clock on the CPU
    phase_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    #: the global index of ``population``'s first member: the ensemble
    #: engine's result holds this rank's block of members; the loop's, all
    member_offset: int = 0
    #: on a mesh whose model axes split members, the member dims split in
    #: each leaf (the block holds shards; ``gather_population`` takes it)
    shard_dims: Optional[List[tuple]] = None
    #: on a pipeline mesh, whether each leaf's layers are split into
    #: stages (the block holds this rank's stage; ``gather_population``
    #: takes it)
    stage_split: Optional[List[bool]] = None
    #: the ensemble engine's mesh (None from the loop): the serving
    #: functions gather the whole population over it before they soup,
    #: pick a member or serve the ensemble
    mesh: Any = None


class _PhaseClock:
    """Marks on the device's own clock; read once, after the loop, so the
    timing adds no synchronization to the steps."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._spans: List[tuple] = []

    def mark(self):
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def add(self, phase: str, step: int, start, end) -> None:
        self._spans.append((phase, step, start, end))

    def per_step(self, steps: int) -> Dict[str, List[float]]:
        """Milliseconds a step in each of :data:`PHASES` and in any other
        phase an engine marked (the pipelined engine's ticks)."""
        if self._cuda:
            torch.cuda.synchronize()
        out = {p: [0.0] * steps for p in PHASES}
        for phase, step, a, b in self._spans:
            out.setdefault(phase, [0.0] * steps)[step] += (
                a.elapsed_time(b) if self._cuda else (b - a) * 1e3)
        return out


def _grad_step(loss_fn, params_m: Tree, batch):
    """Loss and gradients of one member; ``params_m`` holds views of the
    stacked leaves, detached so that gradients land per member."""
    leaves = [x.detach().requires_grad_() for x in pop.tree_leaves(params_m)]
    it = iter(leaves)
    loss = loss_fn(pop.tree_map(lambda _: next(it), params_m), batch)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), pop.tree_map(lambda _: next(it), params_m)


def train_population(seed: int, init_fn: Callable[[int], Tree],
                     loss_fn: Callable[[Tree, Any], torch.Tensor],
                     data_fn: Callable[[int, int, int], Any],
                     tcfg: TrainConfig, mcfg: MixingConfig, num_blocks: int,
                     record_every: int = 25,
                     record_fn: Optional[Callable[[int, Tree],
                                                  Dict[str, float]]] = None,
                     engine: str = "vmap",
                     device: DeviceLike = "cuda", mesh=None,
                     engine_opts: Optional[Dict[str, Any]] = None
                     ) -> TrainResult:
    """Train a population on ``device`` (the card unless the caller asks
    for the CPU); ``init_fn`` must put the parameters there.
    ``engine="vmap"`` is this module's reference loop; ``"shard_map"``
    runs the ensemble engine
    (:func:`repro_torch.train.engine.train_population_sharded`), which
    also takes ``mesh`` (a :class:`repro_torch.launch.mesh.EnsMesh`) and
    ``engine_opts`` (``async_staging``, ``split_gate_runs``,
    ``param_specs``)."""
    if engine == "shard_map":
        from repro_torch.train.engine import train_population_sharded

        return train_population_sharded(
            seed, init_fn, loss_fn, data_fn, tcfg, mcfg, num_blocks,
            record_every=record_every, record_fn=record_fn, mesh=mesh,
            device=device, **(engine_opts or {}))
    if engine != "vmap":
        raise ValueError(f"unknown engine {engine!r}")
    if mesh is not None:
        raise ValueError("mesh= is only consumed by engine='shard_map'; the "
                         "vmap reference loop runs on one device")
    if engine_opts:
        raise ValueError(f"engine_opts={sorted(engine_opts)} are only "
                         "consumed by engine='shard_map'")
    dev = resolve_device(device)
    n = tcfg.population
    population = pop.init_population(init_fn, seed, n, same_init=tcfg.same_init)
    for x in pop.tree_leaves(population):
        if x.device != dev:
            raise ValueError(f"init_fn put parameters on {x.device}; the "
                             f"loop trains on {dev}")
    lids = infer_layer_ids(pop.member(population, 0), num_blocks)
    tl = total_layers(num_blocks)

    opt_init, opt_update = make_optimizer(
        tcfg.optimizer, momentum=tcfg.momentum, weight_decay=tcfg.weight_decay)
    opt_state = opt_init(population)  # moments (N, ...), as vmap(opt_init)
    opt_state["step"] = torch.zeros((n,), dtype=torch.int32, device=dev)

    # exact float64 comm per mixing step from the plan sizes; None for
    # dense WASH (data-dependent Bernoulli masks: use mix_once's count)
    member_tpl = pop.tree_map(
        lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"),
        population)
    static_comm = static_mix_comm(member_tpl, mcfg, lids, tl, n,
                                  opt_state=opt_state)

    history: Dict[str, List[float]] = {
        "step": [], "loss": [], "consensus": [], "comm": []}
    comm_total = 0.0
    base_seed = fold_in(seed, 1234)
    data_seed = fold_in(seed, 5678)
    clock = _PhaseClock(dev)
    tel = obs.get()
    # mirrors comm_total add for add, so the counter equals the exact
    # host-side accounting bit for bit
    comm_counter = (tel.registry.counter("train.comm_scalars")
                    if tel.enabled else None)

    t0 = time.time()
    for step in range(tcfg.total_steps):
        lr = cosine_lr(step, tcfg.total_steps, tcfg.lr, tcfg.min_lr,
                       tcfg.warmup_steps)
        ds = fold_in(data_seed, step)
        losses = []
        with tel.span("train.step", step=step):
            for m in range(n):
                batch = data_fn(m, step, fold_in(ds, m))
                a = clock.mark()
                loss, grads = _grad_step(loss_fn, pop.member(population, m),
                                         batch)
                b = clock.mark()
                opt_update(pop.member(population, m), grads,
                           pop.member(opt_state, m), lr)
                c = clock.mark()
                clock.add("fwd_bwd", step, a, b)
                clock.add("opt", step, b, c)
                losses.append(loss)
                del grads
            loss = torch.mean(torch.stack(losses).float())

        if mixing_due(step, mcfg):
            a = clock.mark()
            population, opt_state, comm = mix_once(
                step_seed(base_seed, step), population, opt_state, mcfg,
                lids, tl)
            clock.add("mix", step, a, clock.mark())
            if static_comm is not None and comm != static_comm:
                raise RuntimeError(
                    f"step {step}: the applied plans sent {comm} scalars per "
                    f"member, the shapes give {static_comm}")
            comm_step = float(comm) if static_comm is None else static_comm
            comm_total += comm_step
            if comm_counter is not None:
                comm_counter.inc(comm_step)
                tel.event("train.comm_volume", comm_per_mix_step=comm_step,
                          mix_steps=1, comm_total=comm_total)

        if step % record_every == 0 or step == tcfg.total_steps - 1:
            history["step"].append(step)
            history["loss"].append(float(loss))
            history["consensus"].append(
                float(avg_distance_to_consensus(population)))
            history["comm"].append(comm_total)
            extras = {}
            if record_fn is not None:
                for k_, v in record_fn(step, population).items():
                    history.setdefault(k_, []).append(v)
                    extras[k_] = v
            if tel.enabled:
                tel.registry.gauge("train.loss").set(history["loss"][-1])
                wall = time.time() - t0
                if wall > 0:
                    tel.registry.gauge("train.steps_per_s").set(
                        (step + 1) / wall)
                for k_, v in extras.items():
                    tel.registry.gauge(f"train.record.{k_}").set(v)
                tel.event("train.record", step=step,
                          loss=history["loss"][-1],
                          consensus=history["consensus"][-1],
                          comm=comm_total, **extras)

    phase_ms = clock.per_step(tcfg.total_steps)
    history["wall_s"] = [time.time() - t0]
    if tel.enabled:
        tel.registry.gauge("train.wall_s").set(history["wall_s"][0])
    return TrainResult(population, opt_state, history, comm_total, phase_ms)
