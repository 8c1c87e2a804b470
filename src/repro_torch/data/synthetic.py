"""Deterministic synthetic LM data.

Port of the LM task of ``repro/data/synthetic.py``: an order-1 Markov
chain over a small vocabulary with a random, Zipf-weighted transition
table (each state prefers a few successors), so perplexity is learnable
down to the chain's entropy.  Everything is drawn from integer seeds with
``torch.Generator``s (``core.prng``): deterministic given the seed, but
not the reference's numbers.  Every member of a population draws its own
stream (its own seed).  The image task waits for the CNN quickstart.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.prng import fold_in, generator


@dataclasses.dataclass(frozen=True)
class LMTask:
    table: torch.Tensor  # (V, V) float32 transition logits
    vocab: int


def _gumbel(shape, seed: int, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator(seed, device), device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def make_lm_task(seed: int, vocab: int = 256, branching: float = 4.0,
                 device="cuda") -> LMTask:
    """Gumbel(0, 1) transition logits scaled by ``branching``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return LMTask(_gumbel((vocab, vocab), seed, resolve_device(device))
                  * branching, vocab)


def sample_tokens(task: LMTask, seed: int, batch: int, seq: int
                  ) -> torch.Tensor:
    """(batch, seq) int64 token ids: a uniform first token, then each next
    token drawn from the chain's row of the previous one (Gumbel-max)."""
    device = task.table.device
    x = torch.randint(0, task.vocab, (batch,), generator=generator(
        fold_in(seed, 0), device), device=device)
    noise = _gumbel((max(seq - 1, 0), batch, task.vocab), fold_in(seed, 1),
                    device)
    out = [x]
    for t in range(seq - 1):
        x = torch.argmax(task.table[x] + noise[t], dim=-1)
        out.append(x)
    return torch.stack(out, dim=1)
