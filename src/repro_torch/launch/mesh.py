"""The ensemble mesh: which members this process trains, on which device.

Port of ``repro/launch/mesh.py::make_host_ensemble_mesh`` on
``torch.distributed``.  The reference lays a one-axis ``ens`` mesh over
the host's devices; here the axis is the process group that ``torchrun``
starts, one rank per device (one card per rank: NCCL refuses two ranks
on one device).  Rank r of a world of m holds the contiguous block of
n_local = N / m members starting at global member r * n_local.

World size and rank come from an initialized default process group,
else from ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), else the world is 1 and no group is made.  The backend
is ``nccl`` on the card (``cuda:LOCAL_RANK``) and ``gloo`` on the CPU;
nothing falls back from one to the other.

Where the reference picks the largest divisor of N that fits the host,
the launcher fixes the world here, so a population that does not divide
over it is refused.

:func:`make_host_mesh` lays the multi-axis meshes (``ens_dp``: (E, D);
``ens_dp_mp``: (E, D, M); the pipeline's ``ens_pp``: (E, S) and
``ens_dp_pp``: (E, D, S)) over the world with the reference's fill, one
rank a device, ranks row-major over the axes (as the reference's
``make_mesh`` lays out the host's devices): a :class:`HostMesh`, with a
process group for each set of axes the engine reduces over, and on a
pipe axis the global ranks of the neighbouring stages.

Serving lays one axis over the world, or over a subgroup of it
(:class:`ServeMesh`): :func:`make_host_data_mesh` a ``data`` group that
splits a request's rows (the reference's ``make_host_data_mesh``; at
world 1 the (1,) mesh), :func:`make_host_pipe_mesh` S pipeline stages
that each hold a contiguous slice of the blocks.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import types
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.shardplan import PIPE_AXIS, AxisRoles, classify_roles

HOST_MESH_AXES = {
    "ens": ("ens",),
    "ens_dp": ("ens", "data"),
    "ens_dp_mp": ("ens", "data", "model"),
    "ens_pp": ("ens", "pipe"),
    "ens_dp_pp": ("ens", "data", "pipe"),
}


@dataclasses.dataclass
class EnsMesh:
    """This process's place on the ensemble axis.

    ``group`` is the process group the ring runs on (None at world 1, the
    default group otherwise, or a subgroup the caller made); ``rank`` and
    ``world`` are taken within it.  ``owns_group`` marks a default group
    this mesh initialized, which :meth:`close` destroys."""

    rank: int
    world: int
    n_local: int
    member_offset: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    owns_group: bool = False

    @property
    def members(self) -> range:
        """Global indices of the members this rank holds."""
        return range(self.member_offset, self.member_offset + self.n_local)

    def global_rank(self, rank: int) -> int:
        """The default group's rank of ``rank`` in :attr:`group` (a
        point-to-point op names its peer by global rank)."""
        if self.group is None or self.group is dist.group.WORLD:
            return rank
        return dist.get_global_rank(self.group, rank)

    def close(self) -> None:
        """Destroy the default group if this mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _world_and_rank(group) -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group), False
    if group is not None:
        raise ValueError("a process group was given, but none is initialized")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    return world, rank, world > 1


def host_world() -> int:
    """The number of ranks this process runs among: the initialized
    default group's, else ``torchrun``'s ``WORLD_SIZE``, else 1."""
    return _world_and_rank(None)[0]


def _rank_device(device: DeviceLike, world: int, rank: int) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` across ranks on the card
    (refused with more ranks than cards), else ``device`` itself."""
    if torch.device(device).type == "cuda" and world > 1:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"{world} ranks on {cards} card(s): the engine runs one card "
                f"per rank (NCCL refuses two ranks on one device)")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
        return dev
    return resolve_device(device)


def _init(dev: torch.device, world: int, rank: int) -> None:
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", world_size=world, rank=rank)


def make_host_ensemble_mesh(population: int, device: DeviceLike = "cuda",
                            group=None) -> EnsMesh:
    """The ``ens`` mesh of this process for a population of ``population``
    on ``device`` ("cuda" unless the caller asks for the CPU).  Raises,
    before it makes a process group, when the population does not divide
    over the world or the world has more ranks than the host has cards."""
    world, rank, init = _world_and_rank(group)
    if population % world:
        raise ValueError(f"population {population} does not divide over "
                         f"{world} ranks of the ens axis")
    dev = _rank_device(device, world, rank)
    if init:
        _init(dev, world, rank)
    if world > 1 and group is None:
        group = dist.group.WORLD
    n_local = population // world
    return EnsMesh(rank=rank, world=world, n_local=n_local,
                   member_offset=rank * n_local, device=dev,
                   group=group if world > 1 else None, owns_group=init)


def _largest_divisor(x: int, cap: int) -> int:
    """Largest divisor of ``x`` that is <= ``cap`` (>= 1)."""
    return max(s for s in range(1, max(min(x, cap), 1) + 1) if x % s == 0)


def host_mesh_shape(population: int, kind: str, devices: int, *,
                    mesh_shape=None, pp_stages: Optional[int] = None
                    ) -> Tuple[int, ...]:
    """The axis sizes of mesh ``kind`` over ``devices`` devices, as the
    reference's ``make_host_mesh`` fills them: E the largest divisor of
    the population that fits, the pipe axis ``pp_stages`` (default 1),
    the model axis all that is left, the data axis the rest (so 1 when
    there is a model axis).  ``mesh_shape`` replaces the fill: one size an
    axis, all >= 1, their product dividing ``devices`` and E dividing the
    population."""
    if kind not in HOST_MESH_AXES:
        raise ValueError(f"unknown host mesh kind {kind!r}")
    axes = HOST_MESH_AXES[kind]
    if mesh_shape is not None:
        shape = tuple(int(s) for s in mesh_shape)
        if len(shape) != len(axes) or any(s < 1 for s in shape):
            raise ValueError(
                f"mesh shape {shape} does not match mesh kind {kind!r} "
                f"(axes {axes}: need {len(axes)} sizes >= 1)")
        total = int(np.prod(shape))
        if devices % total:
            raise ValueError(f"mesh shape {shape} needs {total} devices, "
                             f"which does not divide the {devices} here")
        if population % shape[0]:
            raise ValueError(f"population {population} must divide over ens "
                             f"axis of size {shape[0]}")
        return shape
    e = _largest_divisor(population, devices)
    if kind == "ens":
        return (e,)
    rest = devices // e
    sizes = {"ens": e}
    if PIPE_AXIS in axes:
        s = 1 if pp_stages is None else int(pp_stages)
        if s < 1 or rest % s:
            raise ValueError(
                f"pp_stages={s} must divide the {rest} devices left after "
                f"ens={e} ({devices} devices); pass mesh_shape for an "
                f"explicit layout")
        sizes[PIPE_AXIS] = s
        rest //= s
    if "model" in axes:
        sizes["model"] = _largest_divisor(rest, rest)
        rest //= sizes["model"]
    if "data" in axes:
        sizes["data"] = rest
    return tuple(sizes[a] for a in axes)


@dataclasses.dataclass
class AxisGroup:
    """The ranks of a :class:`HostMesh` that differ only along ``axes``:
    this rank's place among them (its coordinate over ``axes``,
    row-major) and their process group (None when they are one rank)."""

    axes: Tuple[str, ...]
    rank: int
    world: int
    group: Optional[dist.ProcessGroup] = None


@dataclasses.dataclass
class HostMesh:
    """This process's place on a multi-axis mesh of ranks.

    ``axis_names`` and ``shape`` are what the shard-local planner reads
    (``core/shardplan.py``), ``coords`` this rank's coordinate on each
    axis, ``roles`` each axis's role for the population.  The process
    groups: ``pop`` (an :class:`EnsMesh` over the population axes: the
    ring, PAPA's mean, the members this rank holds), ``data`` (the data
    axes that split batches: the gradient mean), ``model`` (the axes that
    shard members: gather and slice), ``loss`` (population and data:
    the step's loss) and ``pipe`` (the pipeline stages of this rank's
    members: the replicated leaves' gradient sum, the stages' gather).
    Every group but ``pipe`` keeps the pipe coordinate fixed, so rings
    and means stay inside one stage.  ``prev_rank`` / ``next_rank`` are
    the global ranks of the previous and next stage (None at the ends,
    and without a pipe axis)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    roles: AxisRoles
    rank: int
    device: torch.device
    pop: EnsMesh
    data: AxisGroup
    model: AxisGroup
    loss: AxisGroup
    pipe: AxisGroup = dataclasses.field(
        default_factory=lambda: AxisGroup((), 0, 1))
    prev_rank: Optional[int] = None
    next_rank: Optional[int] = None
    owns_group: bool = False

    @property
    def stage(self) -> int:
        """This rank's pipeline stage (0 without a pipe axis)."""
        return self.pipe.rank

    @property
    def num_stages(self) -> int:
        return self.pipe.world

    @property
    def n_local(self) -> int:
        return self.pop.n_local

    @property
    def member_offset(self) -> int:
        return self.pop.member_offset

    @property
    def members(self) -> range:
        return self.pop.members

    def close(self) -> None:
        """Destroy the default group if this mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _axis_group(names, sizes, coords, axes, world: int) -> AxisGroup:
    """The group of the ranks that share this rank's coordinates off
    ``axes``.  Every rank makes every such group, in one order (a group
    is made by all ranks or none), including groups it is not in."""
    axes = tuple(a for a in names if a in axes)
    size = int(np.prod([sizes[a] for a in axes])) if axes else 1
    pos = 0
    for a in axes:
        pos = pos * sizes[a] + coords[a]
    if size == 1:
        return AxisGroup(axes, 0, 1, None)
    if size == world:
        return AxisGroup(axes, pos, size, dist.group.WORLD)
    others = [a for a in names if a not in axes]
    mine = None
    for off in itertools.product(*(range(sizes[a]) for a in others)):
        fixed = dict(zip(others, off))
        ranks = []
        for on in itertools.product(*(range(sizes[a]) for a in axes)):
            c = {**fixed, **dict(zip(axes, on))}
            r = 0
            for a in names:
                r = r * sizes[a] + c[a]
            ranks.append(r)
        # torch numbers a group's ranks in sorted order: row-major ranks
        # make that the coordinate order over the axes
        assert ranks == sorted(ranks)
        pg = dist.new_group(ranks)
        if fixed == {a: coords[a] for a in others}:
            mine = pg
    return AxisGroup(axes, pos, size, mine)


def make_host_mesh(population: int, kind: str = "ens", *, mesh_shape=None,
                   pp_stages: Optional[int] = None,
                   device: DeviceLike = "cuda", group=None):
    """The host mesh of ``kind`` over the world ``torchrun`` starts.

    ``ens`` without ``mesh_shape`` is :func:`make_host_ensemble_mesh`.
    The others (and an explicit ``mesh_shape``) take
    :func:`host_mesh_shape`'s sizes, with the world as the device count,
    and give a :class:`HostMesh`.  Refused before any process group is
    made: a shape whose product is not the world, a population that does
    not divide over the ens axis, a ``pp_stages`` that does not divide
    the ranks left after the ens axis, more ranks than cards on the
    card."""
    if kind not in HOST_MESH_AXES:
        raise ValueError(f"unknown host mesh kind {kind!r}")
    if kind == "ens" and mesh_shape is None:
        return make_host_ensemble_mesh(population, device, group)
    if group is not None:
        raise ValueError("a multi-axis mesh spans the whole world")
    axes = HOST_MESH_AXES[kind]
    world, rank, init = _world_and_rank(None)
    shape = host_mesh_shape(population, kind, world, mesh_shape=mesh_shape,
                            pp_stages=pp_stages)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has "
                         f"{int(np.prod(shape))} ranks; the world has {world}")
    sizes = dict(zip(axes, shape))
    if kind == "ens":
        return make_host_ensemble_mesh(population, device)
    roles = classify_roles(types.SimpleNamespace(axis_names=axes,
                                                 shape=sizes), population)
    dev = _rank_device(device, world, rank)
    if init:
        _init(dev, world, rank)
    coords, r = {}, rank
    for a in reversed(axes):
        r, coords[a] = divmod(r, sizes[a])
    coords = {a: coords[a] for a in axes}
    pop_g = _axis_group(axes, sizes, coords, roles.pop_axes, world)
    data_g = _axis_group(axes, sizes, coords, roles.dp_axes, world)
    model_g = _axis_group(axes, sizes, coords, roles.model_axes, world)
    loss_g = _axis_group(axes, sizes, coords,
                         roles.pop_axes + roles.dp_axes, world)
    pipe = roles.pipe_axis
    pipe_g = _axis_group(axes, sizes, coords, (pipe,) if pipe else (), world)
    prev_rank = next_rank = None
    if pipe:
        # ranks are row-major over the axes: a stage apart is a stride of
        # the sizes of the axes after the pipe axis
        stride = int(np.prod([sizes[a] for a in axes[axes.index(pipe) + 1:]]))
        if coords[pipe] > 0:
            prev_rank = rank - stride
        if coords[pipe] < sizes[pipe] - 1:
            next_rank = rank + stride
    n_local = population // pop_g.world
    pop = EnsMesh(rank=pop_g.rank, world=pop_g.world, n_local=n_local,
                  member_offset=pop_g.rank * n_local, device=dev,
                  group=pop_g.group)
    return HostMesh(axis_names=axes, shape=sizes, coords=coords, roles=roles,
                    rank=rank, device=dev, pop=pop, data=data_g,
                    model=model_g, loss=loss_g, pipe=pipe_g,
                    prev_rank=prev_rank, next_rank=next_rank,
                    owns_group=init)


@dataclasses.dataclass
class ServeMesh:
    """This process's place on a serving mesh of one axis, ``data`` or
    ``pipe``: ``axis_names`` and ``shape`` as the serving engine and
    ``sharding.rules`` read them, the ``data`` and ``pipe`` groups (the
    axis the mesh lacks is one rank), and on the pipe axis the global
    ranks of the neighbouring stages (None at the ends)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    device: torch.device
    data: AxisGroup
    pipe: AxisGroup
    prev_rank: Optional[int] = None
    next_rank: Optional[int] = None
    owns_group: bool = False

    @property
    def stage(self) -> int:
        return self.pipe.rank

    @property
    def num_stages(self) -> int:
        return self.pipe.world

    def global_rank(self, axis: AxisGroup, rank: int) -> int:
        """The default group's rank of ``rank`` in ``axis``'s group."""
        if axis.group is None or axis.group is dist.group.WORLD:
            return rank
        return dist.get_global_rank(axis.group, rank)

    def close(self) -> None:
        """Destroy the default group if this mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _serve_mesh(axis: str, size: Optional[int], device: DeviceLike,
                group) -> ServeMesh:
    world, rank, init = _world_and_rank(group)
    if size is not None and size != world:
        raise ValueError(f"{size} pipeline stages need {size} ranks; the "
                         f"{'group' if group is not None else 'world'} has "
                         f"{world}")
    dev = _rank_device(device, world, rank)
    if init:
        _init(dev, world, rank)
    if world > 1 and group is None:
        group = dist.group.WORLD
    mine = AxisGroup((axis,), rank, world, group if world > 1 else None)
    one = AxisGroup((), 0, 1)
    mesh = ServeMesh(axis_names=(axis,), shape={axis: world},
                     rank=dist.get_rank() if world > 1 else 0, device=dev,
                     data=mine if axis == "data" else one,
                     pipe=mine if axis == PIPE_AXIS else one,
                     owns_group=init)
    if axis == PIPE_AXIS:
        if rank > 0:
            mesh.prev_rank = mesh.global_rank(mine, rank - 1)
        if rank < world - 1:
            mesh.next_rank = mesh.global_rank(mine, rank + 1)
    return mesh


def make_host_data_mesh(device: DeviceLike = "cuda", group=None) -> ServeMesh:
    """The serving ``data`` mesh over the world ``torchrun`` starts (or
    over ``group``): one rank a card, each holding the whole model and
    serving its rows of a request.  A world of 1 gives the (1,) mesh and
    makes no process group."""
    return _serve_mesh("data", None, device, group)


def make_host_pipe_mesh(stages: int, device: DeviceLike = "cuda",
                        group=None) -> ServeMesh:
    """The serving ``pipe`` mesh of ``stages`` stages, one rank each, over
    the world ``torchrun`` starts (or over ``group``): stage s is the
    group's rank s.  Refused, before any process group is made, when the
    world (the group) is not ``stages`` ranks or has more ranks than the
    host has cards."""
    if stages < 1:
        raise ValueError(f"pp_stages={stages} must be >= 1")
    return _serve_mesh(PIPE_AXIS, stages, device, group)
