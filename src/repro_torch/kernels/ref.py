"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py:37`` ``paged_attention_ref``.  The CPU path
of :func:`repro_torch.kernels.ops.paged_attention` runs this, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Gather-then-attend paged decode attention.

    q: (B,H,hd); k_pool/v_pool: (P,page_size,KV,hd);
    page_table: (B,max_pages) int; lengths: (B,) int -> (B,H,hd).

    Materializes each slot's context contiguously, then a masked softmax
    in float32 with scores divided by sqrt(hd) and ``NEG_INF`` (not -inf)
    on masked positions, as ``models.layers.sdpa`` does.  ``k_scale`` /
    ``v_scale`` (``(P,)`` float32) dequantize int8 pools: page ``p`` reads
    as ``pool[p] * scale[p]``.
    """
    B, H, hd = q.shape
    _, page_size, KV, _ = k_pool.shape
    g = H // KV
    pt = page_table.long()
    k = k_pool[pt].reshape(B, -1, KV, hd)  # (B, max_pages*ps, KV, hd)
    v = v_pool[pt].reshape(B, -1, KV, hd)
    if k_scale is not None:
        ps = k_scale[pt].repeat_interleave(page_size, dim=1)  # (B, ctx)
        k = k.float() * ps[:, :, None, None]
    if v_scale is not None:
        ps = v_scale[pt].repeat_interleave(page_size, dim=1)
        v = v.float() * ps[:, :, None, None]
    qf = q.reshape(B, KV, g, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qf, k.float()) / (hd ** 0.5)
    valid = (torch.arange(k.shape[1], device=q.device)[None, :]
             < lengths.to(q.device)[:, None])  # (B, ctx)
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w, v.float())
    return out.reshape(B, H, hd).to(q.dtype)
