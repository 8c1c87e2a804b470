"""Roofline terms of a step the port runs on ``meta`` tensors.

Counterpart of ``repro/launch/hlo_stats.py``.  There is no HLO to parse:
the port runs eagerly, so :class:`StepCounter` runs the port's own step
on meta tensors (nothing allocated, nothing computed) and counts, per
card:

* **FLOPs:** ``torch.utils.flop_counter.FlopCounterMode`` (matmul-class
  ops only: elementwise FLOPs are not counted, so no figure compares
  with XLA's ``cost_analysis``; compare with 6·N·D) plus each kernel's
  operations, which a meta route reports (``kernels/ops.py``, the counts
  of ``kernels/work.py`` that PERF.md §6 divides by for each bound).
* **Bytes:** the sum over aten ops of their input and output bytes (views
  and allocations move nothing), plus each kernel's bytes.  Each eager op
  does go through HBM, so this is what the port moves; it is not
  comparable with XLA's fused byte count.
* **Peak live bytes:** the largest sum of the storages made inside the
  step and still alive, over the step.  Each op's new storage is tracked
  through a weak reference to every tensor on it (views share one), so
  autograd's saved tensors, the gradient and the optimizer's float32
  temporaries all count while they live.  Tensors made before the step
  (the resident parameters and moments) are the caller's to add.

The card's constants are the H100 SXM's as PERF.md §6 uses them:
989 TFLOP/s dense bf16, 3.35 TB/s of HBM3, and NVLink's 450 GB/s a
direction a card (the data sheet's 900 GB/s is both directions).
Collective bytes come from ``core/collectives.py``'s events
(:func:`collective_summary`), or from the dry run's own accounting of
what the port would issue on a mesh it does not have.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.collectives import KINDS, Event
from repro_torch.kernels import ops

# H100 SXM constants (per card)
PEAK_FLOPS = 989e12   # dense bf16 FLOP/s
HBM_BW = 3.35e12      # B/s
LINK_BW = 450e9       # NVLink B/s, one direction

#: ops that allocate without moving a byte
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(obj, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    return out


class _Tally(TorchDispatchMode):
    """Bytes through every aten op, and the live storages made inside."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.live: Dict[int, List[int]] = {}  # storage -> [nbytes, tensors]
        self.cur = 0
        self.peak = 0
        self.ops = 0

    def _drop(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.cur -= entry[0]
            del self.live[key]

    def _watch(self, t: torch.Tensor, key: int) -> None:
        self.live[key][1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        ins = _tensors((args, kwargs), [])
        outs = _tensors(out, [])
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _ALLOC:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        in_keys = {_key(x) for x in ins}
        for t in outs:
            key = _key(t)
            if key in in_keys:  # a view or an in-place result
                if key in self.live:
                    self._watch(t, key)
                continue
            if key not in self.live:
                nb = t.untyped_storage().nbytes()
                self.live[key] = [nb, 0]
                self.cur += nb
            self._watch(t, key)
        self.peak = max(self.peak, self.cur)
        return out


class StepCounter:
    """Count a step run on meta tensors inside ``with StepCounter() as c``:
    ``c.flops``, ``c.bytes``, ``c.peak_bytes`` (see the module), and
    ``c.kernels`` (kernel -> [calls, bytes, operations]) for the kernels'
    meta routes.  The counted FLOPs include the kernels' operations and
    the bytes the kernels' bytes."""

    def __init__(self) -> None:
        self.kernels: Dict[str, List[int]] = {}
        self._flops = FlopCounterMode(display=False)
        self._tally = _Tally()

    def _kernel(self, name: str, nbytes: int, nops: int) -> None:
        entry = self.kernels.setdefault(name, [0, 0, 0])
        entry[0] += 1
        entry[1] += nbytes
        entry[2] += nops

    def __enter__(self) -> "StepCounter":
        ops.work_counters.append(self._kernel)
        self._flops.__enter__()
        self._tally.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._tally.__exit__(*exc)
        self._flops.__exit__(*exc)
        ops.work_counters.remove(self._kernel)

    @property
    def matmul_flops(self) -> int:
        return int(self._flops.get_total_flops())

    @property
    def kernel_flops(self) -> int:
        return sum(v[2] for v in self.kernels.values())

    @property
    def kernel_bytes(self) -> int:
        return sum(v[1] for v in self.kernels.values())

    @property
    def flops(self) -> int:
        return self.matmul_flops + self.kernel_flops

    @property
    def bytes(self) -> int:
        return self._tally.bytes + self.kernel_bytes

    @property
    def peak_bytes(self) -> int:
        return self._tally.peak

    @property
    def ops(self) -> int:
        return self._tally.ops


# ---------------------------------------------------------------------------
# collective summaries (the counterparts of hlo_stats.py:98-186)
# ---------------------------------------------------------------------------


def collective_bytes(events: Iterable[Event]) -> Dict[str, int]:
    """Bytes per collective kind (every kind present, 0 when absent)."""
    out = {k: 0 for k in KINDS}
    for e in events:
        out[e.kind] += e.nbytes
    return out


def collective_counts(events: Iterable[Event]) -> Dict[str, int]:
    """Ops per collective kind (every kind present, 0 when absent)."""
    out = {k: 0 for k in KINDS}
    for e in events:
        out[e.kind] += 1
    return out


def collective_dtypes(events: Iterable[Event]) -> Dict[str, set]:
    """The dtypes each kind present moved, e.g. ``{"all_reduce":
    {"float32"}}``."""
    out: Dict[str, set] = {}
    for e in events:
        out.setdefault(e.kind, set()).add(e.dtype)
    return out


def point_to_point_pairs(events: Iterable[Event]) -> List[Tuple[int, int]]:
    """(src, dst) global ranks of every send and receive, in issue order."""
    return [e.pair for e in events if e.pair is not None]


def collective_summary(events: Sequence[Event]) -> Dict[str, object]:
    return {"bytes": collective_bytes(events),
            "counts": collective_counts(events),
            "dtypes": {k: sorted(v)
                       for k, v in collective_dtypes(events).items()},
            "pairs": point_to_point_pairs(events)}


# ---------------------------------------------------------------------------
# the roofline helpers (same formulas as hlo_stats.py:209-252)
# ---------------------------------------------------------------------------


def roofline_terms(flops: float, bytes_hbm: float, coll: Dict[str, int],
                   chips: int, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Dict[str, float]:
    """All inputs are per card; ``chips`` is kept for the global-FLOPs
    cross-check ``flops * chips ≈ model_flops``."""
    cbytes = float(sum(coll.values()))
    return {
        "compute_s": flops / peak_flops,
        "memory_s": bytes_hbm / hbm_bw,
        "collective_s": cbytes / link_bw,
        "collective_bytes": cbytes,
        "global_flops": flops * chips,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    t = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(t, key=t.get)


def model_flops(n_params: int, n_active: int, tokens: int) -> float:
    """6·N·D rule (dense) / 6·N_active·D (MoE)."""
    return 6.0 * n_active * tokens


def summarize(flops: float, nbytes: float, coll: Dict[str, int],
              chips: int) -> Dict[str, float]:
    """The roofline terms and the counted figures of one step, per card,
    with ``bytes_<kind>`` for every collective kind."""
    terms = roofline_terms(flops, nbytes, coll, chips)
    terms.update({
        "counted_flops": float(flops),
        "counted_bytes": float(nbytes),
        "dominant": dominant_term(terms),
        **{f"bytes_{k}": float(v) for k, v in coll.items()},
    })
    return terms


def fits(per_card_bytes: float) -> bool:
    """Whether ``per_card_bytes`` fit what a card offers
    (:data:`CARD_BYTES`)."""
    return per_card_bytes <= CARD_BYTES


#: what one H100 80GB HBM3 offers the port's tensors, as measured on the
#: card (PERF.md §6)
CARD_BYTES = 79.18 * 2 ** 30
