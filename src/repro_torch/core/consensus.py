"""Consensus (averaged-model) distance metrics — paper Fig. 2 / Eq. 2 / Eq. 5.

Port of ``repro/core/consensus.py``.  Reductions run in float32 over
column chunks of each stacked leaf, so a full-width bf16 population never
has a float32 copy of a whole leaf at once; the sums are taken in another
order than XLA's (tests hold them within a tolerance).
"""

from __future__ import annotations

from typing import Any, Iterator

import torch
import torch.distributed as dist

from repro_torch.core.population import tree_leaves, tree_map

Tree = Any

#: columns of a stacked (N, D) leaf reduced at a time
CHUNK = 1 << 24


def _chunks(x: torch.Tensor) -> Iterator[torch.Tensor]:
    """Float32 column blocks of the stacked leaf ``x`` viewed as (N, D)."""
    flat = x.reshape(x.shape[0], -1)
    for a in range(0, flat.shape[1], CHUNK):
        yield flat[:, a:a + CHUNK].float()


def consensus(population: Tree) -> Tree:
    """θ̄ = mean over the ens axis."""
    return tree_map(lambda x: torch.mean(x, dim=0), population)


def sq_distance_to_consensus(population: Tree) -> torch.Tensor:
    """Σ_n ‖θ_n − θ̄‖² — the exact quantity preserved by Eq. (5)."""
    leaves = tree_leaves(population)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        for xc in _chunks(x):
            total = total + torch.sum((xc - xc.mean(dim=0, keepdim=True)) ** 2)
    return total


def avg_distance_to_consensus(population: Tree) -> torch.Tensor:
    """(1/N) Σ_n ‖θ_n − θ̄‖ — the Fig. 2 trace."""
    leaves = tree_leaves(population)
    n = leaves[0].shape[0]
    per_member = torch.zeros((n,), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        for xc in _chunks(x):
            per_member = per_member + torch.sum(
                (xc - xc.mean(dim=0, keepdim=True)) ** 2, dim=1)
    return torch.mean(torch.sqrt(per_member))


def avg_distance_to_consensus_blocked(block: Tree, mesh, shard_dims=None,
                                      stage_split=None) -> torch.Tensor:
    """:func:`avg_distance_to_consensus` of a population spread over the
    ranks of ``mesh``, each holding its ``(n_local, ...)`` block: the
    consensus by an all-reduce of the column sums over the population
    group, the members' distances summed by another.  On a
    :class:`repro_torch.launch.mesh.HostMesh` whose model group splits
    leaves (``shard_dims``: a tuple of member dims for each leaf, as
    :func:`repro_torch.core.population.gather_population` takes it) or
    whose pipe group splits leaves into stages (``stage_split``: a bool
    for each leaf), a member's squared distance over the split leaves is
    summed over that group before the square root, the replicated leaves
    counted once; data replicas hold the same block and reduce nothing.
    Every rank gets the same value; at world 1 it is the stacked function
    itself."""
    pop_mesh = getattr(mesh, "pop", mesh)
    groups = []  # (the group that splits leaves, which leaves it splits)
    model, pipe = getattr(mesh, "model", None), getattr(mesh, "pipe", None)
    if shard_dims is not None and model is not None and model.world > 1:
        groups.append((model, [bool(d) for d in shard_dims]))
    if stage_split is not None and pipe is not None and pipe.world > 1:
        groups.append((pipe, [bool(s) for s in stage_split]))
    groups = [(g, split) for g, split in groups if any(split)]
    if pop_mesh.world == 1 and not groups:
        return avg_distance_to_consensus(block)
    leaves = tree_leaves(block)
    n_local = leaves[0].shape[0]
    n = n_local * pop_mesh.world
    per_member = torch.zeros((n_local,), dtype=torch.float32,
                             device=leaves[0].device)
    per_group = [torch.zeros_like(per_member) for _ in groups]
    for i, x in enumerate(leaves):
        for xc in _chunks(x):
            mean = torch.sum(xc, dim=0, keepdim=True)
            if pop_mesh.world > 1:
                dist.all_reduce(mean, group=pop_mesh.group)
            sq = torch.sum((xc - mean / n) ** 2, dim=1)
            j = next((j for j, (_, split) in enumerate(groups) if split[i]),
                     None)
            if j is None:
                per_member = per_member + sq
            else:
                per_group[j] = per_group[j] + sq
    for (g, _), part in zip(groups, per_group):
        dist.all_reduce(part, group=g.group)
        per_member = per_member + part
    total = torch.sum(torch.sqrt(per_member))
    if pop_mesh.world > 1:
        dist.all_reduce(total, group=pop_mesh.group)
    return total / n


def pairwise_distance(population: Tree) -> torch.Tensor:
    """Mean pairwise L2 distance between members (diversity diagnostic)."""
    leaves = tree_leaves(population)
    n = leaves[0].shape[0]
    sq = torch.zeros((n, n), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        for xc in _chunks(x):
            sq = sq + torch.sum((xc[:, None] - xc[None]) ** 2, dim=-1)
    dist = torch.sqrt(sq)
    mask = 1.0 - torch.eye(n, device=sq.device)
    return torch.sum(dist * mask) / torch.clamp(torch.sum(mask), min=1.0)
