"""End-of-training evaluation strategies (paper §4 'Evaluation strategy').

Port of ``repro/core/averaging.py``:

  Ensemble   : average the *predictions* (softmax probs) of all members.
  Averaged   : uniform weight soup θ̄ = (1/N) Σ θ_n.
  GreedySoup : add members in decreasing val-accuracy order, keep a member
               only if it does not lower the running soup's val accuracy.

``balanced_mean`` and ``uniform_soup`` use the reference's fixed
pairwise-sum tree followed by one divide, so in float32 the result is
bitwise the JAX one.  Where the reference vmaps a model over the stacked
members, the port loops over them: one member's activations exist at a
time.  Accuracies are 0-d (or, per member, 1-d) float32 tensors on the
parameters' device.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from repro_torch.core.population import (member, population_size, tree_leaves,
                                         tree_map)

Tree = Any
ApplyFn = Callable[[Tree, Any], torch.Tensor]


def balanced_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis 0 as a fixed balanced pairwise-sum tree.

    Same arithmetic DAG as the reference: adjacent rows are summed pair by
    pair (an odd row carries up unchanged) until one row is left, then it
    is divided by N once."""
    rows = [x[i] for i in range(x.shape[0])]
    n = len(rows)
    while len(rows) > 1:
        nxt = [rows[i] + rows[i + 1] for i in range(0, len(rows) - 1, 2)]
        if len(rows) % 2:
            nxt.append(rows[-1])
        rows = nxt
    return rows[0] / n


def uniform_soup(stacked: Tree) -> Tree:
    """Uniform weight soup θ̄ = (1/N) Σ θ_n, leafwise :func:`balanced_mean`."""
    return tree_map(balanced_mean, stacked)


#: bytes of one member's slice of a leaf that :func:`uniform_soup_` averages
#: at once; a larger leaf is averaged a slice of its second axis at a time
SOUP_SLICE_BYTES = 1 << 28


def uniform_soup_(stacked: Tree) -> Tree:
    """:func:`uniform_soup` computed in place: each leaf's soup is written
    into member 0's slot of the stacked leaf, and member 0's views are
    returned.  A leaf whose member slice passes :data:`SOUP_SLICE_BYTES` is
    averaged in slices of its second axis (the layer axis of a stacked
    block leaf), so no more than such a slice is ever held twice; the
    result is bitwise :func:`uniform_soup`'s (``balanced_mean`` is
    elementwise).  The population is spent: its other members are left as
    they were, member 0 becomes the soup."""
    def soup(x: torch.Tensor) -> torch.Tensor:
        row = x[0].numel() * x.element_size()
        if x.dim() < 2 or row <= SOUP_SLICE_BYTES:
            x[0] = balanced_mean(x)
            return x[0]
        step = max(1, SOUP_SLICE_BYTES * x.shape[1] // row)
        for i in range(0, x.shape[1], step):
            x[0, i:i + step] = balanced_mean(x[:, i:i + step])
        return x[0]

    return tree_map(soup, stacked)


def soup_of(stacked: Tree, indices: Sequence[int]) -> Tree:
    """The mean of the members ``indices`` (``torch.mean`` over them; the
    reference's ``jnp.mean`` sums in its own order)."""
    return tree_map(lambda x: torch.mean(torch.stack([x[i] for i in indices]),
                                         dim=0), stacked)


def _member_logits(apply_fn: ApplyFn, stacked: Tree, batch):
    for m in range(population_size(stacked)):
        yield apply_fn(member(stacked, m), batch)


def ensemble_logprobs(apply_fn: ApplyFn, stacked: Tree, batch) -> torch.Tensor:
    """log of the member-averaged softmax (the paper's Ensemble), (B, C)."""
    total = None
    for logits in _member_logits(apply_fn, stacked, batch):
        probs = torch.softmax(logits, dim=-1)
        total = probs if total is None else total + probs
    return torch.log(total / population_size(stacked) + 1e-9)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


def ensemble_accuracy(apply_fn: ApplyFn, stacked: Tree, batch,
                      labels: torch.Tensor) -> torch.Tensor:
    return _accuracy(ensemble_logprobs(apply_fn, stacked, batch), labels)


def member_accuracies(apply_fn: ApplyFn, stacked: Tree, batch,
                      labels: torch.Tensor) -> torch.Tensor:
    """(N,) accuracy of each member."""
    return torch.stack([_accuracy(logits, labels) for logits in
                        _member_logits(apply_fn, stacked, batch)])


def model_accuracy(apply_fn: ApplyFn, params: Tree, batch,
                   labels: torch.Tensor) -> torch.Tensor:
    return _accuracy(apply_fn(params, batch), labels)


def greedy_soup_members(apply_fn: ApplyFn, stacked: Tree, val_batch,
                        val_labels: torch.Tensor) -> List[int]:
    """The members GreedySoup keeps, in the order it took them: the best
    member first (a stable descending sort of the accuracies: ties keep
    member order), then each next one whose addition leaves the soup's
    accuracy at least as high (``>=``)."""
    accs = member_accuracies(apply_fn, stacked, val_batch, val_labels)
    order = torch.argsort(-accs, stable=True).tolist()
    chosen = [order[0]]
    best = float(model_accuracy(apply_fn, soup_of(stacked, chosen), val_batch,
                                val_labels))
    for i in order[1:]:
        trial = chosen + [i]
        acc = float(model_accuracy(apply_fn, soup_of(stacked, trial),
                                   val_batch, val_labels))
        if acc >= best:
            chosen, best = trial, acc
    return chosen


def greedy_soup(apply_fn: ApplyFn, stacked: Tree, val_batch,
                val_labels: torch.Tensor) -> Tree:
    """GreedySoup of Wortsman et al. (51), as evaluated in the paper."""
    return soup_of(stacked, greedy_soup_members(apply_fn, stacked, val_batch,
                                                val_labels))


def interpolate(stacked: Tree, weights) -> Tree:
    """Arbitrary convex combination Σ w_n θ_n / Σ w_n (Fig. 6
    interpolation heatmaps); ``weights`` has one entry a member."""
    leaves = tree_leaves(stacked)
    w = torch.as_tensor(weights, dtype=torch.float32, device=leaves[0].device)
    n = population_size(stacked)
    if w.shape != (n,):
        raise ValueError(f"{tuple(w.shape)} weights for {n} members")
    w = w / torch.sum(w)
    return tree_map(lambda x: torch.tensordot(
        w, x.to(torch.promote_types(w.dtype, x.dtype)), dims=1), stacked)
