"""Contracts over the collectives a step issues and the buffers it
updates, checked against what the port actually did.

Port of ``repro/analysis/contracts.py``.  Where the reference parses the
optimized HLO that XLA scheduled, the port runs eagerly: a step's
collectives are the events ``core/collectives.py`` records while it runs
(:func:`run_and_check`, :func:`check_events`), and its buffers are the
tensors it was handed.

What a :class:`Contract` can pin down:

* **Collective footprint:** the kinds that must appear
  (``require_collectives``), must not (``forbid_collectives``), and
  exact or bounded op counts per kind (``counts``); kinds are
  ``core.collectives.KINDS`` (``all_reduce``, ``all_gather``,
  ``broadcast``, ``send``, ``recv``).
* **Point-to-point topology:** every send's and receive's (src, dst)
  global ranks must satisfy at least one :class:`PairRule`:
  :func:`stage_ring` (the WASH ring on an (ens, pipe) mesh never crosses
  a stage: ``src ≡ dst mod S``), :func:`forward_hop` (activations move
  one stage forward, never wrapping), :func:`backward_hop` (the
  backward's gradient hop one stage back).  On an (ens, pipe) mesh the
  port's global rank is ``e * S + p`` (``launch/mesh.py::make_host_mesh``
  fills row-major), the reference's device id in the same order.
* **Buffers updated in place** (the eager counterpart of donation):
  every tensor leaf of the arguments named by ``in_place_argnums`` keeps
  its storage (``data_ptr``) across the call, and no leaf is added or
  dropped.  A step that reallocates its population, optimizer state, KV
  cache or paged pools breaks it.
* **Collective dtypes:** the dtypes each kind may move.

Host-side companions, as the reference's: :func:`check_host_comm_f64`,
:func:`replay_comm` and :func:`check_compile_count`.  The port's matrix
of contracts is :mod:`repro_torch.analysis.matrix`; ``python -m
repro_torch.analysis`` runs it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.population import tree_leaves
from repro_torch.launch import op_stats

__all__ = [
    "Contract",
    "CheckReport",
    "ContractViolation",
    "PairRule",
    "stage_ring",
    "forward_hop",
    "backward_hop",
    "storages",
    "check_events",
    "run_and_check",
    "collective_footprint",
    "check_host_comm_f64",
    "replay_comm",
    "check_compile_count",
]


class ContractViolation(AssertionError):
    """A step broke its contract.  ``problems`` lists every failed clause;
    ``report`` (when present) carries the recorded evidence."""

    def __init__(self, name: str, problems: Sequence[str],
                 report: Optional["CheckReport"] = None) -> None:
        self.name = name
        self.problems = list(problems)
        self.report = report
        lines = "\n".join(f"  - {p}" for p in self.problems)
        super().__init__(f"contract {name!r} violated:\n{lines}")


@dataclasses.dataclass(frozen=True)
class PairRule:
    """A predicate over one point-to-point (src, dst) pair."""

    kind: str  # "stage_ring" | "forward_hop" | "backward_hop"
    stages: int

    def __post_init__(self) -> None:
        if self.kind not in ("stage_ring", "forward_hop", "backward_hop"):
            raise ValueError(f"unknown pair rule {self.kind!r}")
        if self.stages < 1:
            raise ValueError("stages must be >= 1")

    def ok(self, src: int, tgt: int) -> bool:
        if self.kind == "stage_ring":
            return src % self.stages == tgt % self.stages
        # on a pipe-only mesh a rank is its stage, on (ens, pipe)
        # rank = e*S + p: either way stage = rank % S and hops never wrap
        if self.kind == "forward_hop":
            return tgt == src + 1 and src % self.stages != self.stages - 1
        return tgt == src - 1 and src % self.stages != 0

    def describe(self) -> str:
        if self.kind == "stage_ring":
            return f"src ≡ tgt (mod {self.stages})"
        if self.kind == "forward_hop":
            return f"tgt == src + 1 (within a {self.stages}-stage pipe)"
        return f"tgt == src - 1 (within a {self.stages}-stage pipe)"


def stage_ring(stages: int) -> PairRule:
    """Pairs stay inside one stage's ens ring: ``src ≡ tgt mod S``."""
    return PairRule("stage_ring", stages)


def forward_hop(stages: int) -> PairRule:
    """Pairs move exactly one stage forward, never wrapping."""
    return PairRule("forward_hop", stages)


def backward_hop(stages: int) -> PairRule:
    """Pairs move exactly one stage backward, never wrapping: the
    gradient hop of a training pipeline's backward."""
    return PairRule("backward_hop", stages)


@dataclasses.dataclass(frozen=True)
class Contract:
    """What one step may do on the wire and with its buffers.

    ``counts`` maps a collective kind to an exact count (int) or an
    inclusive ``(lo, hi)`` range.  ``collective_dtypes`` maps a kind to
    the dtypes (torch names: ``"float32"``, ``"bfloat16"``, ...) it may
    move.  ``in_place_argnums`` are positional arguments of the step
    whose tensor leaves must keep their storage."""

    name: str
    require_collectives: Tuple[str, ...] = ()
    forbid_collectives: Tuple[str, ...] = ()
    counts: Optional[Mapping[str, Any]] = None
    pair_rules: Tuple[PairRule, ...] = ()
    in_place_argnums: Tuple[int, ...] = ()
    collective_dtypes: Optional[Mapping[str, Sequence[str]]] = None


@dataclasses.dataclass
class CheckReport:
    """Recorded evidence and the verdict of one contract check."""

    contract: Contract
    counts: Dict[str, int]
    bytes: Dict[str, int]
    pairs: List[Tuple[int, int]]
    dtypes: Dict[str, set]
    moved: List[str]
    problems: List[str]
    result: Any = None  # what the checked call returned (run_and_check)

    @property
    def ok(self) -> bool:
        return not self.problems


def storages(args: Sequence[Any], argnums: Sequence[int]
             ) -> List[Tuple[int, int, int]]:
    """``(argnum, leaf index, data_ptr)`` of every tensor leaf of the
    arguments ``argnums``."""
    out = []
    for i in argnums:
        if not 0 <= i < len(args):
            raise ValueError(f"in-place argnum {i} out of range for "
                             f"{len(args)} arguments")
        leaves = [x for x in tree_leaves(args[i])
                  if isinstance(x, torch.Tensor)]
        out.extend((i, j, x.data_ptr()) for j, x in enumerate(leaves))
    return out


def _moved(before, after) -> List[str]:
    if len(before) != len(after):
        return [f"the in-place arguments held {len(before)} tensor leaves "
                f"before the call and {len(after)} after"]
    return [f"argument {i} leaf {j} reallocated"
            for (i, j, p), (_, _, q) in zip(before, after) if p != q]


def check_events(events: Sequence[coll.Event], contract: Contract,
                 moved: Sequence[str] = (),
                 raise_on_violation: bool = True) -> CheckReport:
    """Assert ``contract`` against recorded collective ``events`` (and the
    in-place clause's findings ``moved``).  Returns the
    :class:`CheckReport`; raises :class:`ContractViolation` on failure
    unless ``raise_on_violation=False``."""
    counts = op_stats.collective_counts(events)
    byts = op_stats.collective_bytes(events)
    pairs = op_stats.point_to_point_pairs(events)
    dtypes = op_stats.collective_dtypes(events)

    problems: List[str] = []
    for kind in contract.require_collectives:
        if counts.get(kind, 0) == 0:
            problems.append(f"required collective {kind!r} absent")
    for kind in contract.forbid_collectives:
        if counts.get(kind, 0) != 0:
            problems.append(
                f"forbidden collective {kind!r} present "
                f"({counts[kind]} ops, {byts.get(kind, 0)} bytes)")
    if contract.counts:
        for kind, want in contract.counts.items():
            have = counts.get(kind, 0)
            if isinstance(want, tuple):
                lo, hi = want
                if not lo <= have <= hi:
                    problems.append(f"{kind}: {have} ops outside [{lo}, {hi}]")
            elif have != want:
                problems.append(f"{kind}: {have} ops, expected {want}")
    if contract.pair_rules:
        if not pairs:
            problems.append("pair rules given but no point-to-point op ran")
        for src, tgt in pairs:
            if not any(r.ok(src, tgt) for r in contract.pair_rules):
                rules = " or ".join(r.describe() for r in contract.pair_rules)
                problems.append(f"pair ({src} -> {tgt}) violates {rules}")
    problems.extend(f"{m}: not updated in place" for m in moved)
    if contract.collective_dtypes:
        for kind, allowed in contract.collective_dtypes.items():
            extra = dtypes.get(kind, set()) - set(allowed)
            if extra:
                problems.append(f"{kind} moves dtypes {sorted(extra)} "
                                f"outside allowed {sorted(allowed)}")

    report = CheckReport(contract, counts, byts, pairs, dtypes, list(moved),
                         problems)
    if problems and raise_on_violation:
        raise ContractViolation(contract.name, problems, report)
    return report


def run_and_check(fn: Callable, args: Sequence[Any], contract: Contract,
                  buffers: Any = None,
                  raise_on_violation: bool = True) -> CheckReport:
    """Run ``fn(*args)`` once, recording its collectives and the storages
    of its in-place arguments (and of ``buffers``, a tree of state the
    call updates without taking it as an argument: a server's pools)
    before and after, and assert ``contract``.  The report's ``result``
    holds what ``fn`` returned."""
    held = tuple(args) + (buffers,)
    nums = tuple(contract.in_place_argnums) + (
        () if buffers is None else (len(args),))
    before = storages(held, nums)
    with coll.record() as events:
        result = fn(*args)
    moved = _moved(before, storages(held, nums))
    report = check_events(events, contract, moved, raise_on_violation)
    report.result = result
    return report


def collective_footprint(events: Sequence[coll.Event]) -> Dict[str, Any]:
    """One-call summary (counts, bytes, point-to-point pairs) for
    footprint equality assertions."""
    return {"counts": op_stats.collective_counts(events),
            "bytes": op_stats.collective_bytes(events),
            "pairs": op_stats.point_to_point_pairs(events)}


# ---------------------------------------------------------------------------
# host-side contracts: f64 comm accounting + compile counts
# ---------------------------------------------------------------------------


def check_host_comm_f64(values: Mapping[str, Any],
                        name: str = "host-comm") -> None:
    """Comm accounting must be exact host float64: every value a builtin
    ``float`` (numpy scalars and tensors are rejected: a device round
    trip is the truncation hazard the host accounting exists to avoid)
    and finite."""
    problems = []
    for label, v in values.items():
        if type(v) is not float:
            problems.append(f"{label} is {type(v).__name__}, not builtin "
                            "float (host f64)")
        elif not math.isfinite(v):
            problems.append(f"{label} is {v!r}, not finite")
    if problems:
        raise ContractViolation(name, problems)


def replay_comm(per_mix_step: float, gates: Sequence[bool]) -> float:
    """The engines' comm accumulation, replayed: one float64 add per
    mixing-due step, from 0.0, in step order.  Bit-equal comparison with
    an engine's ``comm_scalars`` is the accounting contract."""
    total = 0.0
    for g in gates:
        if g:
            total += per_mix_step
    return total


def check_compile_count(name: str, count: int, expect: Any) -> None:
    """Program-count contract: ``expect`` is an exact int or an inclusive
    ``(lo, hi)`` range (the train engine's is ``(1, 2)``: at most one
    chunk function per gate variant)."""
    if isinstance(expect, tuple):
        lo, hi = expect
        ok = lo <= count <= hi
        want = f"[{lo}, {hi}]"
    else:
        ok = count == expect
        want = str(expect)
    if not ok:
        raise ContractViolation(
            name, [f"compiled {count} executables, contract allows {want}"])
