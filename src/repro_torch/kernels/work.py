"""What each kernel's function must move and compute, from its shapes.

The same counts ``chip_smoke.py`` divides by for a kernel's bound
(PERF.md §6): bytes are each input element the function needs read once
and each output written once; operations count a multiply and an add as
two.  The dry run (``launch/op_stats.py``) adds them up for a step run on
``meta`` tensors, where the data is unknown: a count that depends on the
data (a paged slot's length, the dense shuffle's mask) takes the most it
could need, and says so in its docstring.  Integer arithmetic on shapes:
no tensor is read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: operations an element (b, t, d, s) of the selective scan: the
#: forward's dt A, its exp, dt B u (2), the multiply-add into h (2), h C
#: and its sum over s (2); the backward's recomputed state (6) and its own
#: 22 (g = carry + C dy; du's, ddt's, dB's, dC's and dA's products and
#: sums; the carry a g)
SSM_FWD_OPS, SSM_BWD_OPS = 8, 28

Work = Tuple[int, int]  # (bytes, operations)


def visible_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs of an S-long sequence that attention sees: key
    j <= query i when causal, and j > i - window when windowed (a row at
    a time, so a 500k-token sequence costs no S x S array)."""
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    hi = i if causal else S - 1
    rows = np.broadcast_to(np.maximum(0, hi - lo + 1), (S,))
    return int(rows.sum(dtype=np.int64))


def flash_work(B: int, S: int, H: int, KV: int, hd: int, elt: int,
               causal: bool, window: Optional[int] = None,
               hv: Optional[int] = None) -> Work:
    """Bytes (q, k, v read once, out written once; ``elt`` bytes an
    element) and operations (QK^T over hd and PV over hv = hd unless
    given, a multiply and an add each, over the visible pairs only)."""
    hv = hd if hv is None else hv
    nbytes = elt * (B * S * H * (hd + hv) + B * S * KV * (hd + hv))
    ops = 2 * B * H * (hd + hv) * visible_pairs(S, causal, window)
    return nbytes, ops


def paged_work(B: int, H: int, KV: int, hd: int, page_size: int,
               tokens: int, pages: int, q_elt: int, kv_elt: int,
               scales: bool) -> Work:
    """Bytes and operations of one paged decode call over ``tokens``
    context rows in ``pages`` pages of B slots (K/V: only the rows below
    each slot's length)."""
    nbytes = (2 * tokens * KV * hd * kv_elt        # K and V rows
              + 2 * B * H * hd * q_elt             # q in, out
              + 4 * (pages + B)                    # page-table entries, lengths
              + (8 * pages if scales else 0))      # k/v scales of used pages
    return nbytes, 4 * tokens * H * hd             # QK^T and PV


def paged_work_most(B: int, H: int, KV: int, hd: int, page_size: int,
                    max_pages: int, q_elt: int, kv_elt: int,
                    scales: bool) -> Work:
    """:func:`paged_work` with every slot at its page table's full length:
    the most a call could need (the dry run knows no lengths)."""
    pages = B * max_pages
    return paged_work(B, H, KV, hd, page_size, pages * page_size, pages,
                      q_elt, kv_elt, scales)


def wkv_work(B: int, T: int, H: int, hd: int) -> Work:
    """Bytes (r, k, v, w, u and the state read once, y and the state
    written once, f32) and operations (5 per state element and step)."""
    nbytes = 4 * (5 * B * T * H * hd + H * hd + 2 * B * H * hd * hd)
    return nbytes, 5 * B * T * H * hd * hd


def wkv_bwd_work(B: int, T: int, H: int, hd: int, carried: bool) -> Work:
    """The WKV backward: r, k, v, w, dy read and dr, dk, dv, dw written,
    u and du, with a carried state the state, the final state's grad and
    dstate0; 14 operations a state element and step."""
    nbytes = 4 * (9 * B * T * H * hd + 2 * H * hd
                  + (3 * B * H * hd * hd if carried else 0))
    return nbytes, 14 * B * T * H * hd * hd


def ssm_work(B: int, T: int, DI: int, S: int, carried: bool,
             backward: bool = False) -> Work:
    """The selective scan, float32: each input read once, each output
    written once, ``SSM_FWD_OPS`` or ``SSM_BWD_OPS`` an element."""
    elems = B * T * DI * S
    if backward:
        nbytes = 4 * (5 * B * T * DI + 4 * B * T * S + 2 * DI * S
                      + (3 * B * DI * S if carried else 0))
        return nbytes, SSM_BWD_OPS * elems
    nbytes = 4 * (3 * B * T * DI + 2 * B * T * S + DI * S
                  + (2 * B * DI * S if carried else 0))
    return nbytes, SSM_FWD_OPS * elems


def shuffle_bytes_dense(n: int, d: int, elt: int, mask_count: int,
                        in_place: bool = False) -> int:
    """x read and out written once, the mask once, perm only where the
    mask is set.  ``in_place`` (out is x): only the masked columns change,
    so only their N values are read and written (with every column masked,
    the most it could move, both counts agree)."""
    if in_place:
        return d + n * mask_count * (2 * elt + 4)
    return 2 * n * d * elt + d + 4 * n * mask_count


def shuffle_bytes_bucketed(n: int, k_per: int, elt: int) -> int:
    """Each selected column of buckets 1..N-1 read and written once (N
    values each), plus its plan entry."""
    return 2 * n * (n - 1) * k_per * elt + 4 * (n - 1) * k_per
