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
over it is refused.  The multi-axis meshes (``ens_dp``, ``ens_dp_mp``,
``ens_pp``, ``ens_dp_pp``) are not ported yet (ROADMAP §1,
'Multi-device training').
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.device import DeviceLike, resolve_device

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
    kind = torch.device(device).type
    if kind == "cuda" and world > 1:
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
    else:
        dev = resolve_device(device)
    if init:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", world_size=world,
                                rank=rank)
    if world > 1 and group is None:
        group = dist.group.WORLD
    n_local = population // world
    return EnsMesh(rank=rank, world=world, n_local=n_local,
                   member_offset=rank * n_local, device=dev,
                   group=group if world > 1 else None, owns_group=init)


def make_host_mesh(population: int, kind: str = "ens", *, mesh_shape=None,
                   pp_stages: Optional[int] = None,
                   device: DeviceLike = "cuda", group=None) -> EnsMesh:
    """The host mesh of ``kind``: ``ens`` alone is ported (it is
    :func:`make_host_ensemble_mesh`); the others raise."""
    if kind not in HOST_MESH_AXES:
        raise ValueError(f"unknown host mesh kind {kind!r}")
    if kind != "ens" or mesh_shape is not None or pp_stages is not None:
        raise NotImplementedError(
            f"mesh {kind!r} (mesh_shape={mesh_shape}, pp_stages={pp_stages}) "
            "is not ported yet: only the ens axis is; ROADMAP §1, "
            "'Multi-device training'")
    return make_host_ensemble_mesh(population, device, group)
