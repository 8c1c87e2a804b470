"""Population-powered speculative decoding for the continuous runtime.

Port of ``repro/serving/speculative.py``.  WASH keeps a population whose
uniform soup and whose logit-averaged ensemble are both strong
predictors, and the soup's next token usually agrees with the
ensemble's.  Ensemble decode pays N member steps per emitted token; a
speculative step turns the population into latency instead:

  1. **Draft** — the soup (one model) runs ``k`` ordinary paged decode
     steps over its OWN draft pools, proposing ``d_1 .. d_{k-1}`` per slot.
  2. **Verify** — every member runs ONE teacher-forced paged decode step
     over ``B·k`` rows: row ``(b, j)`` feeds input ``i_j`` (the pending
     token for ``j = 0``, draft ``d_j`` after) at position ``pos_b + j``
     through slot ``b``'s page table (repeated with ``repeat_interleave``,
     so the paged-attention kernel gets the unit-stride table it needs).
     The paged attend writes every row's K/V before attending, so row
     ``j`` sees its sibling rows exactly as ``j`` sequential steps would
     have written them.
  3. **Accept** — ``v_j`` is what plain decode would emit at output index
     ``steps + j`` given inputs ``i_0..i_j``; the longest prefix where
     each draft equals the previous verified token (``d_j == v_{j-1}``)
     is emitted, ``m = 1 + |prefix|`` tokens per slot per call.

Each ``v_j`` is drawn with the per-(request seed, step) generator at step
``steps + j``, exactly as the plain path draws that step, so at float32
KV the emitted stream equals plain decode for greedy AND temperature
sampling (``tests/test_torch_speculative.py``).  Rejected rows leave
stale K/V at positions ``>= pos + m`` in both pools; every later attend
masks by its own length, and they are overwritten before any row reads
them.  The server rolls its page tables back (``ContinuousServer._shrink``).

Where the reference builds one jitted program, the port runs the step as
a plain function over tensors that writes the pools in place.  On the
card each of the ``k`` draft steps and each member's verify step is one
paged-attention kernel launch per layer.  int8 pools compose; the
bitwise claim then relaxes, because a page's scale couples every row
written to it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import averaging
from repro_torch.models import transformer as M

#: draft lengths the property tests exercise; larger k is legal but the
#: verify step's B*k rows grow linearly
MAX_DRAFT_K = 8


def speculative_supported(cfg: ModelConfig) -> Optional[str]:
    """None if speculative decode can serve ``cfg``, else the reason.

    Needs everything suffix/chunk prefill needs (the draft pools are
    filled by the same chunk steps), plus dense MLPs: MoE capacity
    dispatch depends on batch-mates, so a ``B·k``-row verify step would
    not equal the ``k`` sequential ``B``-row steps it replaces."""
    reason = M.paged_prefill_supported(cfg)
    if reason is not None:
        return reason
    if cfg.moe:
        return ("MoE capacity-factor routing depends on batchmates; the "
                "batched verify step would break bitwise parity")
    return None


def speculative_step(cfg: ModelConfig, members: Sequence, pools: Sequence,
                     draft_params, draft_pools, tokens: np.ndarray,
                     positions: np.ndarray, steps: np.ndarray,
                     budgets: np.ndarray, active: np.ndarray,
                     page_tables: np.ndarray, seeds: np.ndarray,
                     temperature: float, greedy: bool, draft_k: int,
                     device: torch.device):
    """One speculative decode call for every slot.

    ``members``/``pools`` are the verify side (one entry per member, the
    ensemble's logits averaged with ``averaging.balanced_mean`` when there
    are several); ``draft_params``/``draft_pools`` the single draft model.
    Page tables are SHARED: the draft pools mirror the verify pools'
    geometry, so one host page is one context slice in both.  Host-side
    inputs are numpy arrays of B slots.  Returns numpy ``(sampled (B, k),
    counts (B,), done (B,))``: ``sampled[b, :counts[b]]`` are slot b's
    emitted tokens, entries past ``counts`` are zero."""
    # the sampler lives with the plain path it must reproduce
    from repro_torch.serving.batching import _sample_rows

    k = int(draft_k)
    if k < 1:
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    B = tokens.shape[0]
    # proposals this call may emit per slot: never past the budget, so
    # speculative writes stay inside the page reservation
    n_valid = np.where(active, np.clip(budgets - steps, 0, k), 0)
    tables = torch.from_numpy(page_tables).to(device)

    def masked(valid: np.ndarray, pos: np.ndarray, tab: torch.Tensor):
        # invalid rows write to (scratch page, offset 0) and read a
        # 1-token scratch context: garbage in, discarded garbage out
        keep = torch.from_numpy(valid).to(device)
        return (torch.from_numpy(np.where(valid, pos, 0).astype(np.int32))
                .to(device),
                torch.where(keep[:, None], tab, torch.zeros_like(tab)))

    # -- draft: k sequential steps of the draft model over its pools -----
    # step j feeds input i_j at pos + j and samples d_{j+1}, the draft's
    # guess for output index steps + j
    inputs: List[torch.Tensor] = []
    cur = torch.from_numpy(tokens).to(device)
    for j in range(k):
        pos_j, tab_j = masked(j < n_valid, positions + j, tables)
        lg, _ = M.decode_step_paged(draft_params, cfg, cur, pos_j,
                                    draft_pools, tab_j)
        inputs.append(cur)
        cur = _sample_rows(lg[:, -1], seeds, steps + j, temperature, greedy)
    stacked = torch.stack(inputs, dim=1)                # (B, k): i_0..i_{k-1}

    # -- verify: ONE step per member over B*k teacher-forced rows --------
    valid2d = np.arange(k)[None, :] < n_valid[:, None]  # (B, k)
    pos2d = positions[:, None] + np.arange(k)[None, :]
    vpos, vtab = masked(valid2d.reshape(-1), pos2d.reshape(-1),
                        tables.repeat_interleave(k, dim=0))
    vtok = stacked.reshape(B * k)
    lgs = [M.decode_step_paged(p, cfg, vtok, vpos, pl, vtab)[0]
           for p, pl in zip(members, pools)]
    logits = (averaging.balanced_mean(torch.stack(lgs)) if len(lgs) > 1
              else lgs[0])                              # (B*k, 1, V)
    lg2d = logits[:, -1].reshape(B, k, -1)
    # v_j drawn exactly as the plain path draws output steps + j
    v = torch.stack([_sample_rows(lg2d[:, j], seeds, steps + j, temperature,
                                  greedy) for j in range(k)], dim=1)
    inputs_h = stacked.cpu().numpy()
    v = v.cpu().numpy()

    # -- accept the longest matching prefix ------------------------------
    # i_{j+1} (= draft d_{j+1}) is right  <=>  it equals v_j
    match = (inputs_h[:, 1:] == v[:, :k - 1]).astype(np.int32)
    m = 1 + np.sum(np.cumprod(match, axis=1), axis=1)
    m = np.minimum(m, np.maximum(n_valid, 1))
    counts = np.where(active, m, 0)
    sampled = np.where(valid2d & (np.arange(k)[None, :] < m[:, None]), v, 0)
    done = active & (steps + counts >= budgets)
    return sampled.astype(np.int32), counts.astype(np.int32), done
