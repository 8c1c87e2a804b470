"""Public kernel entry points: the tensors' device picks the route.

Counterpart of ``repro/kernels/ops.py``.  Where the JAX package picks the
Pallas kernel by backend (``interpret=None``), here a CUDA tensor goes to
the hand-written Hopper kernel and a CPU tensor to the plain PyTorch
version.  There is no switch that turns the kernel off on the card and no
fallback from the kernel to the plain version: a CUDA call the kernel
cannot take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels.ref import paged_attention_ref


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token paged attention for a batch of serving slots.

    q (B,H,hd); k/v_pool (P,page_size,KV,hd); page_table (B,max_pages);
    lengths (B,); optional per-page int8 dequant scales k/v_scale (P,),
    both or neither.  Returns (B,H,hd) in q's dtype."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if q.device.type == "cuda":
        return _pa.paged_attention_cuda(q, k_pool, v_pool, page_table,
                                        lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                                   k_scale, v_scale)
    raise ValueError(f"paged_attention: no route for device {q.device}")
