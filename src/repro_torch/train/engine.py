"""The ensemble engine: population training over the ranks of an ens mesh.

Port of the single-axis body of ``repro/train/engine.py``
(``train_population_sharded`` with an ``ens``-only mesh).  Where the
reference runs each chunk of steps as one donated jit under
``shard_map``, the port runs it as one eager chunk function on every rank
of a ``torch.distributed`` group (:mod:`repro_torch.launch.mesh`):

  * each rank holds a contiguous block of n_local = N / world members
    (the whole population at world 1, as on the reference's one-device
    host),
  * WASH shuffles cross ranks over a ring of sends and receives
    (:func:`repro_torch.core.mixing.mix_collective_blocked`) and PAPA over
    an all-reduce; at world 1 every planned leaf goes through
    ``ops.bucketed_shuffle_``, the CUDA kernel on the card,
  * the host plans every chunk up front (:mod:`repro_torch.train.schedule`):
    chunks end at record steps and are split along runs of equal
    ``mixing_due``, so at most two chunk functions are built a run (one
    with mixing, one collective-free), counted by
    :func:`chunk_trace_count` and ``obs``'s ``compile.train_chunk``,
  * a chunk function runs the chunk's real steps (``chunk.length``; pad
    slots never run, and eager code takes any length, so none is staged)
    with no host sync inside: the last step's loss stays a device tensor
    until the record,
  * batches for chunk k+1 are made on a staging thread while chunk k runs
    (on the thread's default stream, so staging overlaps host work and
    cannot race the compute),
  * comm is counted on the host in exact float64 from the plan sizes
    (:func:`repro_torch.core.mixing.static_mix_comm`).

Member g's data, the step seeds, the optimizer arithmetic and the plans
are the vmap loop's (:mod:`repro_torch.train.loop`), so at world 1 the
engine reproduces it bit for bit under WASH, PAPA and ``none``.  WASH
kinds need bucketed plans: dense ones have no collective form.

On a multi-axis mesh (:class:`repro_torch.launch.mesh.HostMesh`, the
reference's ``pplan`` body) the shard-local planner
(:mod:`repro_torch.core.shardplan`) places the population: members over
the population axes, each member's leaves split over the model axes by
``param_specs`` (``sharding/rules.py``), batches split over the data
axes that do not carry members.  When a leaf is split or a data axis
splits batches, each step of a member gathers it whole over the model
group, runs forward and backward on it, takes the gradients' mean over
the data group, keeps this rank's slice of them and updates its shard
(the optimizers are elementwise, so the update is that of the same
slice of the whole member); the mix is shard-local
(:func:`repro_torch.core.shardplan.mix_collective_sharded`).  Otherwise
the step is the single-axis one, as in the reference.

On a mesh with a pipe axis (``ens_pp``, ``ens_dp_pp``),
:func:`train_population_pipelined` cuts each member's stacked blocks
into S contiguous stages, one a rank (``rules.stage_member_specs``), and
runs the reference's GPipe schedule on :class:`StageFns`: each step
splits a member's batch into M microbatches, runs M forward ticks (stage
0 embeds, the last stage adds each microbatch's loss / M) and then M
backward ticks in reverse, the boundary activations and their gradients
passed between neighbouring stages by matched point-to-point ops.  The
leaves replicated over the stages (embed, head, norms) get their
gradients summed over the pipe group; WASH mixes on per-stage plans
inside each stage's population group.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import population as pop
from repro_torch.core import shardplan
from repro_torch.core.consensus import avg_distance_to_consensus_blocked
from repro_torch.core.device import DeviceLike
from repro_torch.core.layer_index import infer_layer_ids, total_layers
from repro_torch.core.mixing import (MixingConfig, mix_collective_blocked,
                                     static_mix_comm)
from repro_torch.core.prng import fold_in, step_seed
from repro_torch.optim import cosine_lr, make_optimizer
from repro_torch.train.loop import TrainResult, _grad_step, _PhaseClock
from repro_torch.train.schedule import (  # noqa: F401  (re-exported API)
    ChunkPlan,
    Schedule,
    build_schedule,
    chunk_ranges,
    num_pipeline_ticks,
    record_boundaries,
    split_microbatch_sizes,
)

Tree = Any

# chunk functions built (one per variant a run; the reference counts its
# traces, which are its compiles)
_CHUNK_TRACES = [0]


def reset_chunk_trace_count() -> None:
    _CHUNK_TRACES[0] = 0


def chunk_trace_count() -> int:
    return _CHUNK_TRACES[0]


# Below this average of real steps a chunk, CPU runs are faster with
# synchronous staging: the thread handoff costs more than it hides.  On
# the card the host stages while the device computes.
ASYNC_STAGING_MIN_CHUNK_STEPS = 2


def resolve_async_staging(async_staging: Optional[bool],
                          chunks: List[ChunkPlan],
                          device: DeviceLike = "cuda") -> bool:
    """Whether to stage the next chunk on a thread.  An explicit
    True/False wins.  ``None``: off with fewer than two chunks, off on the
    CPU when the average chunk is shorter than
    :data:`ASYNC_STAGING_MIN_CHUNK_STEPS` real steps, on otherwise."""
    if async_staging is not None:
        return bool(async_staging)
    if len(chunks) < 2:
        return False
    if torch.device(device).type == "cpu":
        avg = sum(c.length for c in chunks) / len(chunks)
        return avg >= ASYNC_STAGING_MIN_CHUNK_STEPS
    return True


class Staged(NamedTuple):
    """A chunk's inputs: per real step, its index, this rank's members'
    batches, the learning rate, the shared mixing seed and the gate."""

    steps: List[int]
    batches: List[List[Any]]
    lrs: List[float]
    seeds: List[int]
    gates: List[bool]


def _mean_over(x: torch.Tensor, axes) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the axis group ``axes``."""
    if axes.world > 1:
        x = x.contiguous()
        dist.all_reduce(x, group=axes.group)
        x = x / axes.world
    return x


def make_fused_chunk_fn(mesh, mcfg: MixingConfig, layer_ids: Tree, tl: int,
                        opt_update: Callable, loss_fn: Callable, *,
                        with_mixing: bool = True,
                        clock: Optional[_PhaseClock] = None,
                        pplan: Optional[shardplan.PopulationPlan] = None
                        ) -> Callable:
    """Build the chunk function ``(population, opt_state, staged) ->
    (population, opt_state, loss)``: per step, each local member's
    forward+backward and optimizer update (in place, as the vmap loop
    does them), then the gated collective mix; the loss of the chunk's
    last step is the mean over all N members (the local mean,
    all-reduced; on a multi-axis mesh over the population and data
    groups).  ``with_mixing=False`` builds the collective-free variant
    run on no-mix gate runs.  ``clock`` times the loop's phases a step.
    ``pplan`` (with ``mesh`` a ``HostMesh``) selects the multi-axis body:
    gather, grad, data mean and slice when a leaf is split or a data axis
    splits batches, and shard-local mixing."""
    _CHUNK_TRACES[0] += 1
    obs.get().record_compile("train_chunk", mixing=bool(with_mixing))
    if clock is None:
        clock = _PhaseClock(mesh.device)  # marks that nobody reads
    loss_axes = mesh if pplan is None else mesh.loss
    gathered = pplan is not None and (pplan.any_sharded or bool(pplan.dp_axes))

    def grads_of(population: Tree, m: int, batch):
        if not gathered:
            return _grad_step(loss_fn, pop.member(population, m), batch)
        full = pop.member(shardplan.all_gather_population(
            pop.tree_map(lambda x: x[m:m + 1], population), pplan, mesh), 0)
        loss_m, grads = _grad_step(loss_fn, full, batch)
        del full
        grads = pop.tree_map(lambda g: _mean_over(g, mesh.data).unsqueeze(0),
                             grads)
        return loss_m, pop.member(
            shardplan.shard_population(grads, pplan, mesh), 0)

    def chunk_fn(population: Tree, opt_state: Tree, staged: Staged):
        loss = None
        for step, batches, lr, seed, gate in zip(*staged):
            losses = []
            for m, batch in enumerate(batches):
                a = clock.mark()
                loss_m, grads = grads_of(population, m, batch)
                b = clock.mark()
                opt_update(pop.member(population, m), grads,
                           pop.member(opt_state, m), lr)
                clock.add("fwd_bwd", step, a, b)
                clock.add("opt", step, b, clock.mark())
                losses.append(loss_m)
                del grads
            loss = torch.mean(torch.stack(losses).float())
            if with_mixing and gate:
                a = clock.mark()
                if pplan is None:
                    mix_collective_blocked(seed, population, opt_state, mcfg,
                                           layer_ids, tl, mesh, gate)
                else:
                    shardplan.mix_collective_sharded(
                        seed, population, opt_state, mcfg, pplan, mesh, gate)
                clock.add("mix", step, a, clock.mark())
        return population, opt_state, _mean_over(loss, loss_axes)

    return chunk_fn


def train_population_sharded(
        seed: int, init_fn: Callable[[int], Tree],
        loss_fn: Callable[[Tree, Any], torch.Tensor],
        data_fn: Callable[[int, int, int], Any], tcfg: TrainConfig,
        mcfg: MixingConfig, num_blocks: int, record_every: int = 25,
        record_fn: Optional[Callable[[int, Tree], Dict[str, float]]] = None,
        mesh=None, async_staging: Optional[bool] = None,
        split_gate_runs: bool = True, param_specs=None,
        device: DeviceLike = "cuda") -> TrainResult:
    """:func:`repro_torch.train.loop.train_population` on the ensemble
    engine.  ``mesh`` is this rank's
    :class:`~repro_torch.launch.mesh.EnsMesh` (default:
    :func:`~repro_torch.launch.mesh.make_host_ensemble_mesh` on
    ``device``, made before any parameter) or
    :class:`~repro_torch.launch.mesh.HostMesh` (the multi-axis body);
    ``init_fn`` must put the parameters on its device.
    ``async_staging`` (None: see :func:`resolve_async_staging`),
    ``split_gate_runs`` (see
    :func:`repro_torch.train.schedule.build_schedule`) and
    ``param_specs`` (member-level :class:`repro_torch.sharding.rules.P`
    specs, e.g. from ``rules.param_pspecs``; a multi-axis mesh only) are
    the reference's.  ``record_fn(step, block)`` sees this rank's block.
    The result holds this rank's block of the population and of the
    optimizer state (member shards on a mesh whose model axes split
    them: ``shard_dims`` names the split dims), from global member
    ``member_offset`` on; losses, consensus and comm are the whole
    population's, the same on every rank."""
    if mcfg.kind in ("wash", "wash_opt") and mcfg.mode != "bucketed":
        raise ValueError(
            f"engine='shard_map' only runs bucketed WASH plans; got "
            f"mode={mcfg.mode!r}.  Use mode='bucketed' (identical in "
            f"expectation, Eq. 4) or engine='vmap' for dense plans.")
    multi = mesh is not None and hasattr(mesh, "pop")
    if param_specs is not None and not multi:
        raise ValueError(
            "param_specs shard members over mesh axes; pass a multi-axis "
            "mesh (repro_torch.launch.mesh.make_host_mesh) along with them")
    n = tcfg.population
    if mesh is None:
        from repro_torch.launch.mesh import make_host_ensemble_mesh

        mesh = make_host_ensemble_mesh(n, device)
    pop_world = mesh.pop.world if multi else mesh.world
    if mesh.n_local * pop_world != n:
        raise ValueError(f"population {n} is not {pop_world} ranks x "
                         f"{mesh.n_local} members")
    if multi and param_specs is not None:
        shardplan.check_spec_axes(param_specs, mesh, mesh.roles)
    dev = mesh.device

    first = init_fn(seed if tcfg.same_init
                    else fold_in(seed, mesh.member_offset))
    for x in pop.tree_leaves(first):
        if x.device != dev:
            raise ValueError(f"init_fn put parameters on {x.device}; the "
                             f"engine trains on {dev}")
    member_tpl = pop.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), first)
    lids = infer_layer_ids(member_tpl, num_blocks)
    tl = total_layers(num_blocks)
    pplan = None
    if multi:
        from repro_torch.sharding.rules import P

        specs = (param_specs if param_specs is not None
                 else pop.tree_map(lambda _: P(), member_tpl))
        pplan = shardplan.plan_population_mixing(mesh, member_tpl, specs,
                                                 mcfg, lids, tl, n)

    def shard(member: Tree) -> Tree:
        """This rank's slice of a whole member, each leaf contiguous."""
        if pplan is None or not pplan.any_sharded:
            return member
        return pop.member(shardplan.shard_population(
            pop.tree_map(lambda x: x.unsqueeze(0), member), pplan, mesh), 0)

    first = shard(first)
    if tcfg.same_init:
        population = pop.replicate(first, mesh.n_local)
    else:
        population = pop.stack([first] + [
            shard(init_fn(fold_in(seed, g))) for g in mesh.members[1:]])
    del first

    opt_init, opt_update = make_optimizer(
        tcfg.optimizer, momentum=tcfg.momentum, weight_decay=tcfg.weight_decay)
    opt_state = opt_init(population)
    opt_state["step"] = torch.zeros((mesh.n_local,), dtype=torch.int32,
                                    device=dev)

    split_rows = None
    if pplan is not None:
        comm_per_mix_step = shardplan.static_shard_mix_comm(
            pplan, opt_state=opt_state)
        if pplan.dp_axes:
            split_rows, _ = _probe_split_rows(data_fn, seed, pplan, mesh)
    else:
        comm_per_mix_step = static_mix_comm(member_tpl, mcfg, lids, tl, n,
                                            opt_state=opt_state)

    sched = build_schedule(tcfg.total_steps, record_every, mcfg,
                           split_gate_runs=split_gate_runs)
    clock = _PhaseClock(dev)
    fused: Dict[bool, Callable] = {}

    def get_fused(chunk: ChunkPlan) -> Callable:
        if chunk.mixing not in fused:
            fused[chunk.mixing] = make_fused_chunk_fn(
                mesh, mcfg, lids, tl, opt_update, loss_fn,
                with_mixing=chunk.mixing, clock=clock, pplan=pplan)
        return fused[chunk.mixing]

    return _run_chunked_schedule(
        mesh=mesh, tcfg=tcfg, data_fn=data_fn, sched=sched,
        get_fused=get_fused, population=population, opt_state=opt_state,
        comm_per_mix_step=comm_per_mix_step, record_fn=record_fn, seed=seed,
        async_staging=async_staging, clock=clock, split_rows=split_rows,
        shard_dims=(shardplan.shard_dims(pplan)
                    if pplan is not None and pplan.any_sharded else None))


def _probe_split_rows(data_fn: Callable, seed: int, pplan, mesh):
    """``(d, D)`` when the data axes split every member's batch (every
    batch leaf's rows divide over them: all or nothing, as the reference
    probes), else None (each data replica takes the whole batch); and the
    probe batch."""
    probe = data_fn(0, 0, fold_in(seed, 0))
    if not pplan.dp_axes:
        return None, probe
    d = mesh.data.world
    if all(x.dim() and x.shape[0] % d == 0 for x in pop.tree_leaves(probe)):
        return (mesh.data.rank, d), probe
    return None, probe


# ---------------------------------------------------------------------------
# the pipeline axis: GPipe over stages of the stacked blocks
# ---------------------------------------------------------------------------


class StageFns(NamedTuple):
    """A member's loss in three pieces, cut at the stage boundaries:
    ``embed(params, batch) -> x`` (stage 0), ``blocks(params, x) -> x``
    (every stage, over the layers of ``params["blocks"]`` it is handed:
    that stage's slice) and ``head(params, x, batch) -> loss`` (the last
    stage).  ``head(p, blocks(p, embed(p, b)), b)`` is the member's loss."""

    embed: Callable[[Tree, Any], torch.Tensor]
    blocks: Callable[[Tree, torch.Tensor], torch.Tensor]
    head: Callable[[Tree, torch.Tensor, Any], torch.Tensor]


def _p2p(tensor: torch.Tensor, peer: int, recv: bool, mesh) -> None:
    """Send ``tensor`` to, or receive it from, global rank ``peer`` over
    the pipe group: one matched point-to-point op, waited on."""
    op = dist.P2POp(dist.irecv if recv else dist.isend, tensor, peer,
                    mesh.pipe.group)
    for req in dist.batch_isend_irecv([op]):
        req.wait()


def _empty(like: torch.Tensor, device) -> torch.Tensor:
    """A contiguous receive buffer of ``like``'s shape and dtype."""
    return torch.empty(like.shape, dtype=like.dtype, device=device)


def _boundary(sf: StageFns, params: Tree, batch) -> torch.Tensor:
    """A ``meta`` tensor of the boundary activation's shape and dtype:
    ``embed`` on ``meta`` copies of the inputs, which compute nothing."""
    def meta(x):
        return x.detach().to("meta")

    return sf.embed(pop.tree_map(meta, params), pop.tree_map(meta, batch))


def make_pipelined_chunk_fn(mesh, mcfg: MixingConfig, opt_update: Callable,
                            stage_fns: StageFns, *, num_micro: int,
                            pplan: shardplan.PopulationPlan,
                            with_mixing: bool = True,
                            clock: Optional[_PhaseClock] = None
                            ) -> Callable:
    """The pipeline's chunk function ``(population, opt_state, staged) ->
    (population, opt_state, loss)`` on this rank's stage
    (``mesh.stage`` of ``mesh.num_stages``).  Per step and local member,
    in one order on every rank: the GPipe schedule of ``num_micro``
    microbatches (M forward ticks, then M backward ticks in reverse; the
    ticks a stage would idle through are not run), the sum of the
    replicated leaves' gradients over the pipe group (each stage holds
    only its own part of their chain rule, zeros elsewhere), the mean
    over the data group when a data axis splits batches, the optimizer;
    then the gated shard-local mix.  The loss is each member's mean of
    microbatch means (float32, added in microbatch order on the last
    stage), summed over the pipe group, then averaged over the members
    and the loss group.  ``clock`` times the phases of :data:`PHASES`
    (``fwd_bwd`` spans both tick phases) and ``fwd_ticks``,
    ``bwd_ticks``, ``stage_compute`` (the ticks less their waits on
    neighbours), ``pipe_sum`` and ``data_mean``."""
    _CHUNK_TRACES[0] += 1
    obs.get().record_compile("train_chunk_pipelined", mixing=bool(with_mixing))
    if clock is None:
        clock = _PhaseClock(mesh.device)  # marks that nobody reads
    sf = StageFns(*stage_fns)
    first = mesh.stage == 0
    last = mesh.stage == mesh.num_stages - 1
    replicated = [not split for split in shardplan.stage_split(pplan)]

    def member_step(params_m: Tree, batch, step: int):
        """One member's GPipe step: ``(loss, grads)``, the loss nonzero on
        the last stage only, the gradients this stage's (zeros for a
        leaf it never touched)."""
        leaves = [x.detach().requires_grad_()
                  for x in pop.tree_leaves(params_m)]
        it = iter(leaves)
        p = pop.tree_map(lambda _: next(it), params_m)
        micro = [pop.tree_map(lambda x: x.chunk(num_micro)[i], batch)
                 for i in range(num_micro)]
        like = None if first else _boundary(sf, p, micro[0])
        acc = torch.zeros((), dtype=torch.float32, device=mesh.device)
        held = []  # (boundary input, what the backward tick starts from)
        a = clock.mark()
        for mb in micro:
            x_in = None
            if not first:
                x_in = _empty(like, mesh.device)
                _p2p(x_in, mesh.prev_rank, True, mesh)
                x_in.requires_grad_()
            c0 = clock.mark()
            y = sf.blocks(p, sf.embed(p, mb) if first else x_in)
            if last:
                loss_mb = sf.head(p, y, mb).float()
                acc = acc + loss_mb.detach()
                held.append((x_in, loss_mb / num_micro))
            else:
                held.append((x_in, y))
            clock.add("stage_compute", step, c0, clock.mark())
            if not last:
                _p2p(y.detach().contiguous(), mesh.next_rank, False, mesh)
        b = clock.mark()
        for x_in, out in reversed(held):
            grad_out = None
            if not last:
                grad_out = _empty(out, mesh.device)
                _p2p(grad_out, mesh.next_rank, True, mesh)
            c0 = clock.mark()
            torch.autograd.backward(out, grad_out)
            clock.add("stage_compute", step, c0, clock.mark())
            if not first:
                _p2p(x_in.grad.contiguous(), mesh.prev_rank, False, mesh)
        del held
        c = clock.mark()
        clock.add("fwd_ticks", step, a, b)
        clock.add("bwd_ticks", step, b, c)
        clock.add("fwd_bwd", step, a, c)
        grads = [x.grad if x.grad is not None else torch.zeros_like(x)
                 for x in leaves]
        it = iter(grads)
        return acc / num_micro, pop.tree_map(lambda _: next(it), params_m)

    def sync_grads(grads: Tree, step: int) -> Tree:
        """The replicated leaves' gradients summed over the pipe group,
        then every gradient's mean over the data group."""
        if mesh.pipe.world > 1:
            a = clock.mark()
            for g, rep in zip(pop.tree_leaves(grads), replicated):
                if rep:
                    dist.all_reduce(g, group=mesh.pipe.group)
            clock.add("pipe_sum", step, a, clock.mark())
        if pplan.dp_axes:
            a = clock.mark()
            grads = pop.tree_map(lambda g: _mean_over(g, mesh.data), grads)
            clock.add("data_mean", step, a, clock.mark())
        return grads

    def chunk_fn(population: Tree, opt_state: Tree, staged: Staged):
        loss = None
        for step, batches, lr, seed, gate in zip(*staged):
            losses = []
            for m, batch in enumerate(batches):
                loss_m, grads = member_step(pop.member(population, m), batch,
                                            step)
                grads = sync_grads(grads, step)
                a = clock.mark()
                opt_update(pop.member(population, m), grads,
                           pop.member(opt_state, m), lr)
                clock.add("opt", step, a, clock.mark())
                losses.append(loss_m)
                del grads
            loss = torch.stack(losses)
            if mesh.pipe.world > 1:
                dist.all_reduce(loss, group=mesh.pipe.group)
            loss = torch.mean(loss)
            if with_mixing and gate:
                a = clock.mark()
                shardplan.mix_collective_sharded(
                    seed, population, opt_state, mcfg, pplan, mesh, gate)
                clock.add("mix", step, a, clock.mark())
        return population, opt_state, _mean_over(loss, mesh.loss)

    return chunk_fn


def train_population_pipelined(
        seed: int, init_fn: Callable[[int], Tree], stage_fns,
        data_fn: Callable[[int, int, int], Any], tcfg: TrainConfig,
        mcfg: MixingConfig, num_blocks: int, record_every: int = 25,
        record_fn: Optional[Callable[[int, Tree], Dict[str, float]]] = None,
        mesh=None, microbatches: int = 1,
        async_staging: Optional[bool] = None, split_gate_runs: bool = True,
        param_specs=None, member_tpl: Optional[Tree] = None,
        device: DeviceLike = "cuda") -> TrainResult:
    """The pipeline-parallel counterpart of
    :func:`train_population_sharded` on a mesh with a ``pipe`` axis
    (:func:`repro_torch.launch.mesh.make_host_mesh` kinds ``ens_pp`` /
    ``ens_dp_pp``; default: ``ens_pp`` on ``device``).  ``stage_fns`` is
    a :class:`StageFns` (or its three functions), e.g. from
    ``models.transformer.pipeline_stage_fns``.  Each member's
    stacked-blocks leaves are cut into S contiguous stages, one a rank of
    the pipe group; every step splits each member's batch into
    ``microbatches`` equal microbatches and runs
    :func:`make_pipelined_chunk_fn`'s GPipe schedule.  WASH mixes on
    per-stage plans inside each stage's population group
    (:mod:`repro_torch.core.shardplan`).

    With one stage and one microbatch it composes the loss and delegates
    to :func:`train_population_sharded` (bitwise equal to it, as the
    reference).  Otherwise refused before ``init_fn`` runs: dense WASH
    plans, a member with no stacked-blocks leaf, layers that do not
    divide over the stages, a local batch that does not split into
    ``microbatches``, a member split over a model axis.  The member's
    shapes come from ``member_tpl`` (a one-member tree; ``meta`` tensors
    do) and, without it, from the first member ``init_fn`` makes.  The
    result holds this rank's stage of its block (``stage_split`` marks
    the stage-split leaves; ``core.population.gather_population`` takes
    it); losses, consensus and comm are the whole population's."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    n = tcfg.population
    if mesh is None:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(n, "ens_pp", device=device)
    if "pipe" not in getattr(mesh, "axis_names", ()):
        raise ValueError(
            f"the pipelined engine needs a mesh with a 'pipe' axis "
            f"(launch.mesh kinds ens_pp/ens_dp_pp); got "
            f"{getattr(mesh, 'axis_names', 'an ens mesh')}")
    sf = StageFns(*stage_fns)
    S = int(mesh.shape["pipe"])

    if S == 1 and microbatches == 1:
        # the degenerate pipeline is the single-stage engine: compose the
        # loss and delegate, bitwise as in the reference
        def loss_fn(pm, b):
            return sf.head(pm, sf.blocks(pm, sf.embed(pm, b)), b)

        return train_population_sharded(
            seed, init_fn, loss_fn, data_fn, tcfg, mcfg, num_blocks,
            record_every=record_every, record_fn=record_fn, mesh=mesh,
            async_staging=async_staging, split_gate_runs=split_gate_runs,
            param_specs=param_specs, device=device)

    if mcfg.kind in ("wash", "wash_opt") and mcfg.mode != "bucketed":
        raise ValueError(
            f"engine='shard_map' only runs bucketed WASH plans; got "
            f"mode={mcfg.mode!r}.")
    if mesh.n_local * mesh.pop.world != n:
        raise ValueError(f"population {n} is not {mesh.pop.world} ranks x "
                         f"{mesh.n_local} members")
    dev = mesh.device
    first = None
    if member_tpl is None:
        first = init_fn(seed if tcfg.same_init
                        else fold_in(seed, mesh.member_offset))
        member_tpl = first
    member_tpl = pop.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        member_tpl)
    lids = infer_layer_ids(member_tpl, num_blocks)
    tl = total_layers(num_blocks)
    if all(isinstance(lid, (int, np.integer))
           for lid in pop.tree_leaves(lids)):
        raise ValueError(
            "stage-split training needs stacked-blocks leaves (one leaf "
            "spanning all blocks along axis 0); this member has only "
            "per-block leaves, which cannot be sharded over the pipe axis")

    from repro_torch.sharding import rules

    specs = (param_specs if param_specs is not None
             else pop.tree_map(lambda _: rules.P(), member_tpl))
    shardplan.check_spec_axes(specs, mesh, mesh.roles)
    pplan = shardplan.plan_population_mixing(
        mesh, member_tpl, rules.stage_member_specs(specs, lids, "pipe"),
        mcfg, lids, tl, n)
    if pplan.any_sharded:
        raise ValueError("the pipelined engine does not split members over "
                         "a model axis")
    shardplan.check_even_stages(pplan)
    split_rows, probe = _probe_split_rows(data_fn, seed, pplan, mesh)
    for x in pop.tree_leaves(probe):
        split_microbatch_sizes(
            x.shape[0] // (split_rows[1] if split_rows else 1), microbatches)
    del probe

    def stage(member: Tree) -> Tree:
        """This rank's stage of a whole member, each leaf contiguous."""
        return pop.member(shardplan.stage_population(
            pop.tree_map(lambda x: x.unsqueeze(0), member), pplan,
            mesh.stage), 0)

    if first is None:
        first = init_fn(seed if tcfg.same_init
                        else fold_in(seed, mesh.member_offset))
    for x in pop.tree_leaves(first):
        if x.device != dev:
            raise ValueError(f"init_fn put parameters on {x.device}; the "
                             f"engine trains on {dev}")
    first = stage(first)
    if tcfg.same_init:
        population = pop.replicate(first, mesh.n_local)
    else:
        population = pop.stack([first] + [
            stage(init_fn(fold_in(seed, g))) for g in mesh.members[1:]])
    del first

    opt_init, opt_update = make_optimizer(
        tcfg.optimizer, momentum=tcfg.momentum, weight_decay=tcfg.weight_decay)
    opt_state = opt_init(population)
    opt_state["step"] = torch.zeros((mesh.n_local,), dtype=torch.int32,
                                    device=dev)
    comm_per_mix_step = shardplan.static_shard_mix_comm(
        pplan, opt_state=opt_state)

    sched = build_schedule(tcfg.total_steps, record_every, mcfg,
                           split_gate_runs=split_gate_runs)
    clock = _PhaseClock(dev)
    fused: Dict[bool, Callable] = {}

    def get_fused(chunk: ChunkPlan) -> Callable:
        if chunk.mixing not in fused:
            fused[chunk.mixing] = make_pipelined_chunk_fn(
                mesh, mcfg, opt_update, sf, num_micro=microbatches,
                pplan=pplan, with_mixing=chunk.mixing, clock=clock)
        return fused[chunk.mixing]

    return _run_chunked_schedule(
        mesh=mesh, tcfg=tcfg, data_fn=data_fn, sched=sched,
        get_fused=get_fused, population=population, opt_state=opt_state,
        comm_per_mix_step=comm_per_mix_step, record_fn=record_fn, seed=seed,
        async_staging=async_staging, clock=clock, split_rows=split_rows,
        stage_split=shardplan.stage_split(pplan))


def _run_chunked_schedule(*, mesh, tcfg: TrainConfig, data_fn: Callable,
                          sched: Schedule, get_fused: Callable,
                          population: Tree, opt_state: Tree,
                          comm_per_mix_step: float, record_fn, seed: int,
                          async_staging: Optional[bool],
                          clock: _PhaseClock, split_rows=None,
                          shard_dims=None, stage_split=None) -> TrainResult:
    """Stage each chunk's inputs (on a thread, one chunk ahead, when
    :func:`resolve_async_staging` allows), run its chunk function, add
    the exact float64 comm a mixing step, and record at the reference
    loop's record steps.  ``split_rows = (d, D)`` keeps rows
    [d·B/D, (d+1)·B/D) of every batch leaf; ``shard_dims`` are the
    model-split dims of the block's leaves and ``stage_split`` marks its
    stage-split leaves (consensus and the result)."""
    base_seed = fold_in(seed, 1234)
    data_seed = fold_in(seed, 5678)

    def rows(batch):
        if split_rows is None:
            return batch
        d, parts = split_rows
        return pop.tree_map(
            lambda x: x[d * (x.shape[0] // parts):
                        (d + 1) * (x.shape[0] // parts)], batch)

    def stage(chunk: ChunkPlan) -> Staged:
        steps = list(chunk.steps)
        batches = []
        for step in steps:
            ds = fold_in(data_seed, step)
            batches.append([rows(data_fn(g, step, fold_in(ds, g)))
                            for g in mesh.members])
        lrs = [cosine_lr(s, tcfg.total_steps, tcfg.lr, tcfg.min_lr,
                         tcfg.warmup_steps) for s in steps]
        seeds = [step_seed(base_seed, s) for s in steps]
        return Staged(steps, batches, lrs, seeds, list(chunk.gates))

    history: Dict[str, List[float]] = {
        "step": [], "loss": [], "consensus": [], "comm": []}
    comm_total = 0.0
    chunks = sched.chunks
    executor = (ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix="wash-stage")
                if resolve_async_staging(async_staging, chunks, mesh.device)
                else None)
    tel = obs.get()
    # mirrors comm_total add for add, so the counter equals the exact
    # host-side accounting bit for bit
    comm_counter = (tel.registry.counter("train.comm_scalars")
                    if tel.enabled else None)

    def staged_timed(chunk: ChunkPlan) -> Staged:
        with tel.span("train.stage", step=chunk.stop - 1):
            return stage(chunk)

    t0 = time.time()
    try:
        nxt = executor.submit(staged_timed, chunks[0]) if executor else None
        for i, chunk in enumerate(chunks):
            staged = nxt.result() if executor else staged_timed(chunk)
            if executor and i + 1 < len(chunks):
                nxt = executor.submit(staged_timed, chunks[i + 1])
            with tel.span("train.chunk_execute", step=chunk.stop - 1,
                          mixing=chunk.mixing):
                population, opt_state, loss_last = get_fused(chunk)(
                    population, opt_state, staged)
            del staged
            mix_steps = 0
            for g in chunk.gates:  # per-step float64 adds, as the loop
                if g:
                    comm_total += comm_per_mix_step
                    mix_steps += 1
                    if comm_counter is not None:
                        comm_counter.inc(comm_per_mix_step)
            if mix_steps and tel.enabled:
                tel.event("train.comm_volume",
                          comm_per_mix_step=comm_per_mix_step,
                          mix_steps=mix_steps, comm_total=comm_total)

            if chunk.record:
                step = chunk.stop - 1
                history["step"].append(step)
                history["loss"].append(float(loss_last))
                history["consensus"].append(float(
                    avg_distance_to_consensus_blocked(
                        population, mesh, shard_dims, stage_split)))
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
                            chunk.stop / wall)
                    tel.event("train.record", step=step,
                              loss=history["loss"][-1],
                              consensus=history["consensus"][-1],
                              comm=comm_total, **extras)
    finally:
        if executor is not None:
            executor.shutdown(wait=True)

    phase_ms = clock.per_step(tcfg.total_steps)
    history["wall_s"] = [time.time() - t0]
    if tel.enabled:
        tel.registry.gauge("train.wall_s").set(history["wall_s"][0])
    return TrainResult(population, opt_state, history, comm_total, phase_ms,
                       member_offset=mesh.member_offset,
                       shard_dims=shard_dims, stage_split=stage_split,
                       mesh=mesh)
