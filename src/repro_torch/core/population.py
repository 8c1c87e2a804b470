"""Stacked populations over nested dicts (and lists) of tensors.

Port of ``repro/core/population.py``.  A *population* of N models is one
tree whose every leaf carries a leading ``ens`` axis of size N.  Trees are
nested ``dict``s and ``list``/``tuple``s with tensors at the leaves; dict
keys are visited in sorted order, as JAX flattens them, so paths and leaf
order agree with the reference package.  :func:`gather_population` is the
ensemble engine's counterpart of the reference's ``host_gather``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.prng import fold_in

Tree = Any
IsLeaf = Optional[Callable[[Any], bool]]


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: IsLeaf = None) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure.  ``is_leaf``
    (tested on ``tree``'s nodes) stops the descent, as in JAX: a dense
    shuffle plan's ``(perm, mask)`` pair is one leaf that way."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree: Tree, prefix: Tuple = (),
               is_leaf: IsLeaf = None) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's flattening order (dict keys sorted,
    sequence entries by index)."""
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_paths(x, prefix + (i,), is_leaf)
    else:
        yield prefix, tree


def tree_leaves(tree: Tree, is_leaf: IsLeaf = None) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree, is_leaf=is_leaf)]


def population_size(population: Tree) -> int:
    leaves = tree_leaves(population)
    if not leaves:
        raise ValueError("empty population tree")
    return int(leaves[0].shape[0])


def stack(members: List[Tree]) -> Tree:
    """Stack a list of per-member trees into one stacked tree."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *members)


def unstack(population: Tree) -> List[Tree]:
    n = population_size(population)
    return [member(population, i) for i in range(n)]


def member(population: Tree, i: int) -> Tree:
    """Member ``i`` as views into the stacked leaves (no copy)."""
    return tree_map(lambda x: x[i], population)


def replicate(params: Tree, n: int) -> Tree:
    """Same-initialization population (the paper's default for WASH)."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone(), params)


def init_population(init_fn: Callable[[int], Tree], seed: int, n: int,
                    same_init: bool = True) -> Tree:
    """Initialize a population from ``init_fn(seed) -> params``.

    ``same_init=True`` follows WASH (all members start at θ0, one
    ``init_fn`` call replicated); ``False`` follows PAPA's setup (member
    i initialized from ``fold_in(seed, i)``)."""
    if same_init:
        return replicate(init_fn(seed), n)
    return stack([init_fn(fold_in(seed, i)) for i in range(n)])


def map_members(fn: Callable, population: Tree, *rest: Tree) -> Tree:
    """``fn`` on each member (and the same member of each tree in
    ``rest``), results stacked: the reference's ``vmap`` over the ens
    axis, written as a loop."""
    n = population_size(population)
    return stack([fn(member(population, i), *(member(r, i) for r in rest))
                  for i in range(n)])


def num_params(params: Tree) -> int:
    """Total scalar count of a single member (population leaves: drop axis 0)."""
    return sum(int(x.numel()) for x in tree_leaves(params))


def all_gather_dims(x: torch.Tensor, dims, group) -> torch.Tensor:
    """Whole leaves from a block of shards ``x`` (n_local, *shard): an
    all-gather over ``group`` (an axis group of a mesh: ``world``,
    ``group``) along member dim d + 1 for each d in ``dims``.  Moves
    values, computes nothing."""
    for d in dims:
        parts = [torch.empty_like(x) for _ in range(group.world)]
        coll.all_gather(parts, x.contiguous(), group=group.group)
        x = torch.cat(parts, dim=d + 1)
    return x


def gather_population(block: Tree, mesh, dst: Optional[int] = 0,
                      shard_dims=None, stage_split=None) -> Optional[Tree]:
    """The whole stacked population on rank ``dst`` (on every rank when
    ``dst`` is None) from each rank's ``(n_local, ...)`` block, members in
    global order; None on the other ranks.  ``mesh`` is an ensemble mesh
    or a multi-axis
    :class:`repro_torch.launch.mesh.HostMesh`, whose ranks hold member
    shards: ``shard_dims`` (a tuple of member dims for each leaf, in leaf
    order) names the dims its model group splits, and ``stage_split`` (a
    bool for each leaf) the leaves whose layers its pipe group splits
    into stages; each leaf is gathered over the model group, then its
    stages concatenated along the layer dim over the pipe group, then
    the members over the population group.  At world 1 the block itself,
    with no copy.  Every rank of the mesh must call it."""
    pop_mesh = getattr(mesh, "pop", mesh)
    model = getattr(mesh, "model", None)
    pipe = getattr(mesh, "pipe", None)
    if model is None or model.world == 1:
        shard_dims = None
    if pipe is None or pipe.world == 1:
        stage_split = None
    if pop_mesh.world == 1 and shard_dims is None and stage_split is None:
        return block
    here = dst is None or mesh.rank == dst
    dims = iter(shard_dims) if shard_dims is not None else None
    stages = iter(stage_split) if stage_split is not None else None

    def gather(x):
        if dims is not None:
            x = all_gather_dims(x, next(dims), model)
        if stages is not None and next(stages):
            x = all_gather_dims(x, (0,), pipe)
        if pop_mesh.world == 1:
            return x if here else None
        parts = [torch.empty_like(x) for _ in range(pop_mesh.world)]
        coll.all_gather(parts, x.contiguous(), group=pop_mesh.group)
        return torch.cat(parts) if here else None

    full = tree_map(gather, block)
    return full if here else None
