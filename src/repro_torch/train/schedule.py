"""Chunk scheduler for the ensemble engine (:mod:`repro_torch.train.engine`).

Port of ``repro/train/schedule.py``, pure Python.  The engine runs one
*chunk* of steps per dispatch; this module plans the whole run up front,
on the host, from ``(total_steps, record_every, mcfg)``:

  1. **Record windows** (:func:`chunk_ranges`) end at the reference
     loop's record steps, where the host reads losses and consensus.
  2. **Gate-run splitting**: each window is split along maximal runs of
     equal :func:`repro_torch.core.mixing.mixing_due`, so no-mix spans run
     on the collective-free chunk function.  WASH (mixing every step)
     keeps one chunk per window; ``none`` one collective-free chunk per
     window; PAPA alternates between the two variants.
  3. **Pad lengths**: every chunk of a variant carries that variant's
     longest run as ``pad_len``, so the reference compiles each variant
     once.  The valid mask (:meth:`ChunkPlan.padded_valid`) is always a
     prefix of ones: the engine runs ``chunk.length`` real steps and pad
     slots never run.

Only the *last* chunk of each record window carries ``record=True``, so
the history schedule is the reference loop's.  :func:`num_pipeline_ticks`
and :func:`split_microbatch_sizes` serve the pipelined engine.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.mixing import MixingConfig, mixing_due


def record_boundaries(total_steps: int, record_every: int) -> List[int]:
    """Steps at which the reference loop records (its host-sync points)."""
    return [
        s for s in range(total_steps)
        if s % record_every == 0 or s == total_steps - 1
    ]


def chunk_ranges(total_steps: int, record_every: int) -> List[Tuple[int, int]]:
    """``[(start, stop))`` chunks covering ``range(total_steps)``, each
    ending on a record boundary, so a chunk only returns to the host
    where the reference loop would have synced anyway."""
    out, start = [], 0
    for b in record_boundaries(total_steps, record_every):
        out.append((start, b + 1))
        start = b + 1
    return out


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """One chunk: steps ``[start, stop)`` padded to ``pad_len``.

    ``gates`` holds the per-real-step ``mixing_due`` results; ``mixing``
    selects the chunk function (collective vs collective-free) and is
    True iff any gate is set.  ``record`` marks the chunk whose last real
    step is a reference-loop record boundary.
    """

    start: int
    stop: int
    gates: Tuple[bool, ...]
    mixing: bool
    record: bool
    pad_len: int

    @property
    def length(self) -> int:
        return self.stop - self.start

    @property
    def steps(self) -> range:
        return range(self.start, self.stop)

    @property
    def pad(self) -> int:
        return self.pad_len - self.length

    def padded_gates(self) -> List[float]:
        """Gate vector: mixing_due per real step, 0 on pads."""
        return [1.0 if g else 0.0 for g in self.gates] + [0.0] * self.pad

    def padded_valid(self) -> List[float]:
        """Per-slot valid mask: 1 on real steps, 0 on pad slots.  Always
        a ones-prefix, which is why the engine encodes it as its
        loop's trip count (``chunk.length``) rather than a select mask."""
        return [1.0] * self.length + [0.0] * self.pad


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The run's full dispatch plan (host-side, static)."""

    chunks: Tuple[ChunkPlan, ...]
    mix_pad_len: int    # pad length of the mixing variant (0 if unused)
    nomix_pad_len: int  # the collective-free variant's (0 if unused)

    def variants(self) -> Tuple[bool, ...]:
        """Distinct chunk functions this schedule runs (≤ 2)."""
        return tuple(sorted({c.mixing for c in self.chunks}))

    def num_padded_steps(self) -> int:
        return sum(c.pad for c in self.chunks)


def num_pipeline_ticks(num_micro: int, num_stages: int) -> int:
    """Forward ticks of one GPipe-scheduled optimizer step: ``M + S - 1``
    (fill + steady state + drain).  At tick ``t`` stage ``s`` processes
    microbatch ``t - s`` when that index is live; the pipelined engine
    masks the fill/drain bubbles, so per-step FLOPs scale by
    ``(M + S - 1) / M`` — the classic GPipe bubble fraction."""
    if num_micro < 1 or num_stages < 1:
        raise ValueError(
            f"need num_micro >= 1 and num_stages >= 1; got "
            f"({num_micro}, {num_stages})"
        )
    return num_micro + num_stages - 1


def split_microbatch_sizes(batch_size: int, num_micro: int) -> Tuple[int, int]:
    """``(num_micro, batch_size // num_micro)`` with an exact-split check.

    Equal microbatches make the pipelined loss (mean of per-microbatch
    means) equal the single-shot batch mean, which is what the S>1
    tolerance-parity contract relies on."""
    if num_micro < 1 or batch_size % num_micro:
        raise ValueError(
            f"batch dim {batch_size} does not split into {num_micro} "
            f"equal microbatches"
        )
    return num_micro, batch_size // num_micro


def _gate_runs(
    wstart: int, wstop: int, gates: List[bool]
) -> List[Tuple[int, int]]:
    """Maximal ``[start, stop)`` runs of equal gate value inside a window."""
    runs, rs = [], wstart
    for s in range(wstart + 1, wstop):
        if gates[s - wstart] != gates[rs - wstart]:
            runs.append((rs, s))
            rs = s
    runs.append((rs, wstop))
    return runs


def build_schedule(
    total_steps: int,
    record_every: int,
    mcfg: MixingConfig,
    *,
    split_gate_runs: bool = True,
) -> Schedule:
    """Plan every chunk of a run.

    ``split_gate_runs=False`` keeps one dispatch per record window
    (useful for A/B benchmarks); chunks whose window mixes anywhere then
    dispatch on the collective variant with their inner gates zeroed on
    no-mix steps.  Either way, chunk lengths are padded to one length a
    variant (the reference compiles each once).
    """
    raw = []  # (start, stop, gates, mixing, record)
    for wstart, wstop in chunk_ranges(total_steps, record_every):
        gates = [mixing_due(s, mcfg) for s in range(wstart, wstop)]
        if split_gate_runs:
            pieces = _gate_runs(wstart, wstop, gates)
        else:
            pieces = [(wstart, wstop)]
        for a, b in pieces:
            g = tuple(gates[a - wstart:b - wstart])
            raw.append((a, b, g, any(g), b == wstop))

    mix_pad = max((b - a for a, b, _, mix, _ in raw if mix), default=0)
    nomix_pad = max((b - a for a, b, _, mix, _ in raw if not mix), default=0)
    chunks = tuple(
        ChunkPlan(a, b, g, mix, rec, mix_pad if mix else nomix_pad)
        for a, b, g, mix, rec in raw
    )
    return Schedule(chunks, mix_pad, nomix_pad)
