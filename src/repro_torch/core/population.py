"""Stacked populations over nested dicts (and lists) of tensors.

Port of ``repro/core/population.py``.  A *population* of N models is one
tree whose every leaf carries a leading ``ens`` axis of size N.  Trees are
nested ``dict``s and ``list``/``tuple``s with tensors at the leaves; dict
keys are visited in sorted order, as JAX flattens them, so paths and leaf
order agree with the reference package.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree: Tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's flattening order (dict keys sorted,
    sequence entries by index)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_paths(x, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


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


def num_params(params: Tree) -> int:
    """Total scalar count of a single member (population leaves: drop axis 0)."""
    return sum(int(x.numel()) for x in tree_leaves(params))
