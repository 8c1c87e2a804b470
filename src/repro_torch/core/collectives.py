"""Every ``torch.distributed`` collective of the port, and a recorder.

The port's modules call these thin wrappers instead of
``torch.distributed`` directly, so what a step puts on the wire can be
read back: under an active :func:`record` each wrapper appends one
:class:`Event` (kind, the group's global ranks, the (src, dst) pair of a
point-to-point op, dtype, bytes) before it issues the op.  Outside
:func:`record` the only cost is one ``None`` check.  This is the port's
counterpart of reading the collectives out of the optimized HLO
(``repro/launch/hlo_stats.py``): ``analysis/contracts.py`` checks a
contract against the events, ``launch/op_stats.py`` sums them.

The wrappers change nothing about the op: same tensors, same group, same
order, waited on where the caller waited.  ``record(dry_rank=r)`` is the
dry run's mode (``launch/dryrun.py``): the events of rank ``r`` of a
mesh that does not exist are recorded and no op is issued; its groups
are stand-ins that carry their global ranks (:class:`DryGroup`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: the kinds an event can have
KINDS = ("all_reduce", "all_gather", "broadcast", "send", "recv")


@dataclasses.dataclass(frozen=True)
class Event:
    """One collective as this process issued it.  ``ranks`` are the
    group's global ranks; ``pair`` is (src, dst) in global ranks for a
    send or a receive, None otherwise; ``nbytes`` is what the op moves
    into its result on this rank (an all-gather: every part)."""

    kind: str
    ranks: Tuple[int, ...]
    pair: Optional[Tuple[int, int]]
    dtype: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """A process group that does not exist: its global ranks, in group
    order (what ``dist.get_process_group_ranks`` gives for a real one)."""

    ranks: Tuple[int, ...]


_events: Optional[List[Event]] = None
_dry_rank: Optional[int] = None


@contextlib.contextmanager
def record(dry_rank: Optional[int] = None) -> Iterator[List[Event]]:
    """Collect the events of every collective issued inside the block (of
    this process), in issue order.  With ``dry_rank``, record as that
    global rank and issue nothing.  Nests: an inner block collects its
    own, the outer one resumes after it."""
    global _events, _dry_rank
    outer = _events, _dry_rank
    _events, _dry_rank = [], dry_rank
    try:
        yield _events
    finally:
        _events, _dry_rank = outer


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ranks(group) -> Tuple[int, ...]:
    if isinstance(group, DryGroup):
        return group.ranks
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def _me() -> int:
    return dist.get_rank() if _dry_rank is None else _dry_rank


def _log(kind: str, t: torch.Tensor, group, pair=None, nbytes=None) -> bool:
    """Append the event; True when the op is to be skipped (dry)."""
    _events.append(Event(kind, _ranks(group), pair, _dtype(t),
                         _nbytes(t) if nbytes is None else nbytes))
    return _dry_rank is not None


def all_reduce(t: torch.Tensor, group=None) -> None:
    """``dist.all_reduce`` (a sum), in place."""
    if _events is not None and _log("all_reduce", t, group):
        return
    dist.all_reduce(t, group=group)


def all_gather(parts: List[torch.Tensor], t: torch.Tensor, group=None) -> None:
    """``dist.all_gather`` of ``t`` into ``parts``."""
    if _events is not None and _log("all_gather", t, group,
                                     nbytes=_nbytes(t) * len(parts)):
        return
    dist.all_gather(parts, t, group=group)


def broadcast(t: torch.Tensor, src: int, group=None) -> None:
    """``dist.broadcast`` from global rank ``src``, in place."""
    if _events is not None and _log("broadcast", t, group):
        return
    dist.broadcast(t, src=src, group=group)


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """A blocking send to global rank ``dst``."""
    if _events is not None and _log("send", t, group, pair=(_me(), dst)):
        return
    dist.send(t, dst=dst, group=group)


def recv(t: torch.Tensor, src: int, group=None) -> None:
    """A blocking receive from global rank ``src`` into ``t``."""
    if _events is not None and _log("recv", t, group, pair=(src, _me())):
        return
    dist.recv(t, src=src, group=group)


def exchange(ops: Sequence[Tuple[str, torch.Tensor, int]], group) -> None:
    """Point-to-point ops posted at once and waited on
    (``dist.batch_isend_irecv``): each of ``ops`` is ``("send" | "recv",
    tensor, peer global rank)`` over ``group``."""
    if _events is not None:
        me = _me()
        for kind, t, peer in ops:
            _log(kind, t, group,
                 pair=(me, peer) if kind == "send" else (peer, me))
        if _dry_rank is not None:
            return
    p2p = [dist.P2POp(dist.isend if kind == "send" else dist.irecv, t, peer,
                      group) for kind, t, peer in ops]
    for req in dist.batch_isend_irecv(p2p):
        req.wait()
