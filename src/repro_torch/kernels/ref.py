"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py`` (``wash_shuffle_ref``,
``flash_attention_ref``, ``paged_attention_ref``, ``rwkv6_scan_ref``), plus
the plain bucketed shuffle (the reference's ``core/shuffle.py``
``bucketed_apply_stacked``), a plain model of how the CUDA paged kernel
splits a slot's context (``paged_attention_partials_ref``,
``merge_partials_ref``) and one of the CUDA WKV kernel's chunked form of
the recurrence (``rwkv6_scan_chunked_ref``; nothing on a main path runs
it), and the WKV recurrence's gradient as its reverse recurrence
(``rwkv6_scan_bwd_ref``, which the JAX package leaves to autodiff) and as
the CUDA backward computes it (``rwkv6_scan_bwd_chunked_ref``; nothing on
a main path runs it).  The
CPU paths of :mod:`repro_torch.kernels.ops` run these, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
# keys a tile of the float32 flash kernel (``kBK`` in csrc/flash_attention.cu)
FLASH_F32_BK = 64
# steps a chunk of the WKV backward (``bwd::kC`` in csrc/rwkv6_scan.cu)
WKV_BWD_CHUNK = 16


def wash_shuffle_ref(x: torch.Tensor, perm: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """x: (N, D); perm: (N, D) int; mask: (D,) bool -> a new (N, D) tensor,
    ``out[n, i] = x[perm[n, i], i]`` where ``mask[i]``, else ``x[n, i]``."""
    shuffled = torch.gather(x, 0, perm)
    return torch.where(mask[None, :], shuffled, x)


def bucketed_shuffle_ref_(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bucketed WASH apply on a stacked ``(N, D)`` tensor, in place.

    ``idx``: ``(N, k_per)`` int with pairwise-disjoint rows; bucket ``s``
    moves its columns by the cyclic shift ``x[n] <- x[(n + s) mod N]``
    (member n takes member n+s's value), bucket 0 is the identity.  The
    N - 1 rounds of ``bucketed_apply_stacked``, each a gather of the
    bucket's columns, a roll along N and a scatter back.  Returns ``x``."""
    n = x.shape[0]
    for s in range(1, n):
        cols = idx[s]
        x[:, cols] = torch.roll(x[:, cols], -s, dims=0)
    return x


def bucketed_shuffle_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Functional form of :func:`bucketed_shuffle_ref_` (the reference's
    signature): shuffles a copy of ``x``."""
    return bucketed_shuffle_ref_(x.clone(), idx)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Self-attention over a whole sequence, as one masked softmax.

    q: (B,S,H,hd); k/v: (B,S,KV,hd), H a multiple of KV (query head h reads
    kv head ``h // (H // KV)``) -> (B,S,H,hd) in q's dtype.  Scores are
    divided by sqrt(hd) in float32; key j is visible to query i where
    ``j <= i`` (when ``causal``) and ``j > i - window`` (when a window is
    given); masked scores are ``NEG_INF``, so no row is all -inf."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qf = q.reshape(B, S, KV, H // KV, hd).float()
    scores = torch.einsum("btkgh,bskh->bkgts", qf, k.float()) / (hd ** 0.5)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & (j > i - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _tf32_split(x: torch.Tensor):
    """float32 ``x`` as the CUDA kernels' ``split_tf32`` hands it to the
    tensor cores, which read the top 19 bits of each register: ``hi`` is x
    rounded to TF32 (ties away), ``lo`` the residual ``x - hi`` truncated
    to TF32.  Emulated on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, products: int = 3):
    """``a @ b`` as 3xTF32: lo_a hi_b + hi_a lo_b + hi_a hi_b, each a
    float32 product of TF32 values (exact) summed in float32; with
    ``products=1``, hi_a hi_b alone (one TF32 product)."""
    a_hi, a_lo = _tf32_split(a)
    b_hi, b_lo = _tf32_split(b)
    if products == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def flash_attention_3xtf32_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = True,
                               window: Optional[int] = None,
                               products: int = 3) -> torch.Tensor:
    """The float32 flash attention computed as the CUDA kernel computes
    it: a plain model of its arithmetic, same contract as
    :func:`flash_attention_ref` (float32 only).

    Scores are 3xTF32 products (:func:`_mm_3xtf32`), scaled by
    ``hd**-0.5 * log2(e)`` in float32; the softmax is online over tiles
    of ``FLASH_F32_BK`` keys in base 2: per tile, the masked scores
    (``NEG_INF``), the new row max m, ``alpha = 2**(m_old - m)``, ``P = 2**(x - m)``,
    ``l = l alpha + sum P`` and ``acc = acc alpha + P V`` with P V in
    3xTF32 too; the output is ``acc / max(l, 1e-20)``.  ``products=1``
    models the one-TF32-product route instead (used by the tests to show
    why the kernel takes three).  Nothing on a main path runs this."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    qh = q.float().permute(0, 2, 1, 3)                         # (B, H, S, hd)
    kh = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vh = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    scale = (torch.tensor(hd ** -0.5, dtype=torch.float32)
             * torch.tensor(1.4426950408889634, dtype=torch.float32))
    i = torch.arange(S, device=q.device)[:, None]
    m = qh.new_full((B, H, S, 1), NEG_INF)
    l = qh.new_zeros((B, H, S, 1))
    acc = qh.new_zeros((B, H, S, hd))
    bk = FLASH_F32_BK
    for k0 in range(0, S, bk):
        j = torch.arange(k0, min(k0 + bk, S), device=q.device)[None, :]
        ok = torch.ones((S, j.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            ok = ok & (j <= i)
        if window is not None:
            ok = ok & (j > i - window)
        x = _mm_3xtf32(qh, kh[:, :, k0:k0 + bk].transpose(-1, -2),
                       products) * scale
        x = x.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _mm_3xtf32(p, vh[:, :, k0:k0 + bk], products)
        m = m_new
    out = acc / l.clamp(min=1e-20)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """The RWKV-6 WKV recurrence, one step at a time, in float32.

    r/k/v/w: (B,T,H,hd), w the per-step decay in (0, 1); u: (H,hd) -> y
    (B,T,H,hd) in r's dtype, with per (batch, head) an (hd x hd) state::

        y_t = r_t . (S + diag(u) k_t^T v_t)
        S  <- diag(w_t) S + k_t^T v_t

    ``state`` None starts from zero and returns ``y`` alone (the TPU
    kernel's function).  Given an initial state (B,H,hd,hd) float32 it
    returns ``(y, final_state)``, as the model's time mix needs."""
    B, T, H, hd = r.shape
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(T):
        k_t = k[:, t].float()
        kv = k_t[..., :, None] * v[:, t].float()[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(), S + uf * kv))
        S = w[:, t].float()[..., None] * S + kv
    y = torch.stack(ys, dim=1).to(r.dtype)
    return y if state is None else (y, S)


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       state: Optional[torch.Tensor], dy: torch.Tensor,
                       dstate_final: Optional[torch.Tensor] = None):
    """The gradient of :func:`rwkv6_scan_ref` written out as the reverse
    recurrence, the plain model of what the CUDA backward kernel computes.

    r/k/v/w/dy: (B,T,H,hd); u: (H,hd); ``state`` the initial state
    (B,H,hd,hd) or None (zero); ``dstate_final`` the gradient of the final
    state or None (zero).  Returns ``(dr, dk, dv, dw, du, dstate0)`` in
    float32, ``dstate0`` None when ``state`` is.  With G_t the adjoint of
    the state after step t, walked back from ``dstate_final``::

        dr_t[i] = sum_j (S_{t-1}[i,j] + u_i k_t[i] v_t[j]) dy_t[j]
        dk_t[i] = sum_j G_t[i,j] v_t[j] + r_t[i] u_i (v_t . dy_t)
        dv_t[j] = sum_i k_t[i] G_t[i,j] + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
        dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
        du[h,i] = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)
        G_{t-1} = diag(w_t) G_t + r_t^T dy_t,   dstate0 = G_{-1}

    A forward walk keeps the state entering every :data:`WKV_BWD_CHUNK`
    steps, and the backward walk recomputes each chunk's states from that
    boundary: the state is never walked backwards (that would divide by w,
    which may be 0), and nothing divides or takes a log.  The CPU path of
    ``ops.rwkv6_scan`` runs this; :func:`rwkv6_scan_bwd_chunked_ref`
    models the CUDA kernel's arithmetic."""
    B, T, H, hd = r.shape
    chunk = WKV_BWD_CHUNK
    r_, k_, v_, w_, dy_ = (x.float() for x in (r, k, v, w, dy))
    uf = u.float()[None]                                   # (1, H, hd)
    S = (r_.new_zeros((B, H, hd, hd)) if state is None
         else state.float().clone())
    bounds = []
    for t in range(T):
        if t % chunk == 0:
            bounds.append(S)
        S = (w_[:, t, ..., None] * S
             + k_[:, t, ..., None] * v_[:, t, :, None, :])
    G = (r_.new_zeros((B, H, hd, hd)) if dstate_final is None
         else dstate_final.float().clone())
    dr, dk, dv, dw = (torch.zeros_like(r_) for _ in range(4))
    du = torch.zeros_like(uf[0])
    for c0 in reversed(range(0, T, chunk)):
        hist = [bounds[c0 // chunk]]             # S_{t-1} for t in the chunk
        for t in range(c0, min(c0 + chunk, T) - 1):
            hist.append(w_[:, t, ..., None] * hist[-1]
                        + k_[:, t, ..., None] * v_[:, t, :, None, :])
        for t in reversed(range(c0, min(c0 + chunk, T))):
            Sp = hist[t - c0]
            rt, kt, vt, wt, dyt = (x[:, t] for x in (r_, k_, v_, w_, dy_))
            vdy = (vt * dyt).sum(-1, keepdim=True)         # (B, H, 1)
            dr[:, t] = (Sp @ dyt[..., None])[..., 0] + uf * kt * vdy
            dk[:, t] = (G @ vt[..., None])[..., 0] + rt * uf * vdy
            bonus = (rt * uf * kt).sum(-1, keepdim=True)
            dv[:, t] = (kt[..., None, :] @ G)[..., 0, :] + bonus * dyt
            dw[:, t] = (G * Sp).sum(-1)
            du += (rt * kt * vdy).sum(0)
            G = wt[..., None] * G + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du, None if state is None else G


def _chunk_decays(w: torch.Tensor):
    """``w`` (..., C, hd) -> (P, Q, Gamma): the exclusive prefix products
    ``P_t = prod_{tau<t} w_tau``, the exclusive suffix products ``Q_t =
    prod_{tau>t} w_tau`` (both (..., C, hd)) and the chunk's whole product
    (..., hd), each a running product of w."""
    C = w.shape[-2]
    p, q = torch.ones_like(w[..., 0, :]), torch.ones_like(w[..., 0, :])
    P, Q = [None] * C, [None] * C
    for t in range(C):
        P[t] = p
        p = p * w[..., t, :]
        Q[C - 1 - t] = q
        q = q * w[..., C - 1 - t, :]
    return torch.stack(P, -2), torch.stack(Q, -2), p


def rwkv6_scan_bwd_chunked_ref(r: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, w: torch.Tensor,
                               u: torch.Tensor,
                               state: Optional[torch.Tensor],
                               dy: torch.Tensor,
                               dstate_final: Optional[torch.Tensor] = None):
    """The gradient of :func:`rwkv6_scan_ref` computed as the CUDA backward
    kernel computes it: a plain model of its arithmetic, same contract as
    :func:`rwkv6_scan_bwd_ref`.

    The sequence is cut into chunks of :data:`WKV_BWD_CHUNK` steps (the
    last padded with r = k = v = dy = 0 and w = 1).  Within a chunk (local steps t,
    ``P``, ``Q``, ``Gamma`` as in :func:`_chunk_decays`, and ``D(s, t) =
    prod_{s<tau<t} w_tau`` for s < t)::

        S_out = diag(Gamma) S_in  + (k * Q)^T v      (forward walk)
        G_in  = diag(Gamma) G_out + (r * P)^T dy     (reverse walk)

    The two walks keep every chunk's entering state S_in and leaving
    adjoint G_out; dstate0 is chunk 0's G_in.  Then, for every chunk at
    once, with X = dy S_in^T, Y = v G_out^T, Z = (k * Q) G_out, the pair
    matrix B2[s][t] = dy_s . v_t and c = sum_j G_out * S_in (per row)::

        dr_t = P_t X_t + V_t[t]          + u k_t B2[t][t]
        dk_t = Q_t Y_t + U_t[t]          + r_t u B2[t][t]
        dv_t = Z_t + sum_{s>=t} A[s][t] dy_s
        dw_t = P_t Q_t c + Q_t L_t + P_t R_t + sum_{s<t} D(s,t) k_s U_t[s]
        du   = sum over batch and chunks of sum_t r_t k_t B2[t][t]

    where, per key channel, V_t[s] = sum_{s'<t} D(s',t) k_s' B2[s][s'] and
    L_t = sum_{s<t} D(s,t) k_s Y_s walk forward (V_{t+1} = w_t V_t + k_t
    B2[:, t], L_{t+1} = w_t L_t + k_t Y_t), U_t[s] = sum_{s'>t} D(t,s')
    r_s' B2[s'][s] and R_t = sum_{s>t} D(t,s) r_s X_s walk back (U_{t-1} =
    w_t U_t + r_t B2[t], R_{t-1} = w_t R_t + r_t X_t), and A[s][t] =
    sum_i r_s k_t D(t,s) (s > t), A[t][t] = sum_i r_t u k_t is the
    forward's pair matrix.  Every factor is a running product of w: nothing
    divides or takes a logarithm, so a decay that underflows to 0 gives
    exact grads."""
    B, T, H, hd = r.shape
    C = WKV_BWD_CHUNK
    pad = -T % C
    n = (T + pad) // C

    def chunks(x, fill):
        x = x.float().permute(0, 2, 1, 3)                     # (B, H, T, hd)
        if pad:
            x = torch.cat([x, x.new_full((B, H, pad, hd), fill)], 2)
        return x.reshape(B, H, n, C, hd)

    r_, k_, v_, dy_ = (chunks(x, 0.0) for x in (r, k, v, dy))
    w_ = chunks(w, 1.0)
    uf = u.float()[None, :, None, :]                          # (1, H, 1, hd)
    P, Q, gamma = _chunk_decays(w_)
    kq, rp = k_ * Q, r_ * P

    # the two chunk walks
    S = (r_.new_zeros((B, H, hd, hd)) if state is None
         else state.float().clone())
    G = (r_.new_zeros((B, H, hd, hd)) if dstate_final is None
         else dstate_final.float().clone())
    s_in, g_out = [None] * n, [None] * n
    for c in range(n):
        s_in[c] = S
        S = gamma[:, :, c, :, None] * S + kq[:, :, c].mT @ v_[:, :, c]
        g_out[n - 1 - c] = G
        G = (gamma[:, :, n - 1 - c, :, None] * G
             + rp[:, :, n - 1 - c].mT @ dy_[:, :, n - 1 - c])
    s_in, g_out = torch.stack(s_in, 2), torch.stack(g_out, 2)

    # every chunk at once: (B, H, n, C, hd) per step and key channel
    X = dy_ @ s_in.mT
    Y = v_ @ g_out.mT
    Z = kq @ g_out
    B2 = dy_ @ v_.mT                                          # [.., s, t]
    c_row = (g_out * s_in).sum(-1)                            # (B, H, n, hd)
    dr, dk, dw_f, dw_b = ([None] * C for _ in range(4))
    # forward over t: V (V[s] for s >= t), L, P
    V = [torch.zeros_like(c_row) for _ in range(C)]
    L = torch.zeros_like(c_row)
    for t in range(C):
        bonus = B2[..., t, t, None]
        dr[t] = P[..., t, :] * X[..., t, :] + V[t] + uf * \
            k_[..., t, :] * bonus
        dw_f[t] = Q[..., t, :] * (P[..., t, :] * c_row + L)
        L = w_[..., t, :] * L + k_[..., t, :] * Y[..., t, :]
        for s in range(t + 1, C):
            V[s] = w_[..., t, :] * V[s] + k_[..., t, :] * B2[..., s, t, None]
    # back over t: U (U[s] for s <= t), R
    U = [torch.zeros_like(c_row) for _ in range(C)]
    R = torch.zeros_like(c_row)
    du = torch.zeros_like(c_row)
    for t in reversed(range(C)):
        bonus = B2[..., t, t, None]
        dk[t] = Q[..., t, :] * Y[..., t, :] + U[t] + r_[..., t, :] * \
            uf * bonus
        cross, d = torch.zeros_like(c_row), torch.ones_like(c_row)
        for s in reversed(range(t)):
            cross = cross + d * k_[..., s, :] * U[s]
            d = d * w_[..., s, :]
        dw_b[t] = P[..., t, :] * R + cross
        du = du + r_[..., t, :] * k_[..., t, :] * bonus
        R = w_[..., t, :] * R + r_[..., t, :] * X[..., t, :]
        for s in range(t):
            U[s] = w_[..., t, :] * U[s] + r_[..., t, :] * B2[..., t, s, None]
    # the pair matrix A, M[t][s] = A[s][t] for s >= t
    M = r_.new_zeros((B, H, n, C, C))
    for t in range(C):
        M[..., t, t] = (r_[..., t, :] * uf * k_[..., t, :]).sum(-1)
        kd = k_[..., t, :]
        for s in range(t + 1, C):
            M[..., t, s] = (r_[..., s, :] * kd).sum(-1)
            kd = kd * w_[..., s, :]
    dv = Z + M @ dy_

    def steps(x):                      # (B, H, n, C, hd) -> (B, T, H, hd)
        return x.reshape(B, H, n * C, hd)[:, :, :T].permute(0, 2, 1, 3)

    def stacked(xs):
        return steps(torch.stack(xs, -2))

    dw = [a + b for a, b in zip(dw_f, dw_b)]
    return (stacked(dr), stacked(dk), steps(dv), stacked(dw),
            du.sum((0, 2)), None if state is None else G)


def rwkv6_scan_chunked_ref(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                           state: Optional[torch.Tensor] = None,
                           chunk: int = 16, keys: int = 32):
    """The WKV recurrence computed as the CUDA kernel computes it: a plain
    model of its algorithm, same contract as :func:`rwkv6_scan_ref`.

    The sequence is walked ``chunk`` steps at a time; the last chunk is
    padded to ``chunk`` with r = k = v = 0 and w = 1.  The key channels are
    split into tiles of ``keys``, as the kernel's blocks split them; within
    a chunk starting at c0, a tile holds its rows of the state ``S_in``
    and, over its own channels only::

        P_t = prod_{c0 <= tau < t} w_tau        (exclusive prefix)
        Q_s = prod_{s < tau < c0 + chunk} w_tau (exclusive suffix)
        G   = prod over the chunk of w_tau
        A[t, s] = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i]  (s < t)
        A[t, t] = sum_i r_t[i] u[i] k_t[i]
        y_part = (r * P) S_in + A v
        S      = diag(G) S_in + (k * Q)^T v

    y is the sum of the tiles' y_part (the kernel's blocks exchange them).
    Every decay factor is a running product of w, never a quotient or a
    logarithm, so a w that underflows to 0 gives 0, not inf or NaN."""
    B, T, H, hd = r.shape
    f = lambda x: x.float().permute(0, 2, 1, 3)  # (B, H, T, hd)
    r_, k_, v_, w_ = f(r), f(k), f(v), f(w)
    pad = -T % chunk
    if pad:
        zeros = r_.new_zeros((B, H, pad, hd))
        r_, k_, v_ = (torch.cat([x, zeros], 2) for x in (r_, k_, v_))
        w_ = torch.cat([w_, torch.ones_like(zeros)], 2)
    S = (r_.new_zeros((B, H, hd, hd)) if state is None
         else state.float().clone())
    uf = u.float()[None]                           # (1, H, hd)
    y = r_.new_zeros((B, H, T + pad, hd))
    for c0 in range(0, T + pad, chunk):
        vc = v_[:, :, c0:c0 + chunk]
        for i0 in range(0, hd, keys):
            ch = slice(i0, i0 + keys)
            rc, kc, wc = (x[:, :, c0:c0 + chunk, ch] for x in (r_, k_, w_))
            P, Q, G = _chunk_decays(wc)
            A = r_.new_zeros((B, H, chunk, chunk))
            for s in range(chunk):
                A[:, :, s, s] = (rc[:, :, s] * uf[..., ch] * kc[:, :, s]).sum(-1)
                kd = kc[:, :, s]
                for t in range(s + 1, chunk):
                    A[:, :, t, s] = (rc[:, :, t] * kd).sum(-1)
                    kd = kd * wc[:, :, t]
            S_in = S[:, :, ch]
            y[:, :, c0:c0 + chunk] += rc * P @ S_in + A @ vc
            S[:, :, ch] = (G[..., None] * S_in
                           + (kc * Q).transpose(-1, -2) @ vc)
    y = y[:, :, :T].permute(0, 2, 1, 3).to(r.dtype)
    return y if state is None else (y, S)


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


def _gathered_scores(q, k_pool, v_pool, page_table, k_scale, v_scale):
    """Each slot's context gathered from its pages (dequantized), and the
    f32 scores of its query rows: ((B, KV, g, ctx) scores, (B, ctx, KV,
    hd) values)."""
    B, H, hd = q.shape
    _, page_size, KV, _ = k_pool.shape
    pt = page_table.long()
    k = k_pool[pt].reshape(B, -1, KV, hd).float()
    v = v_pool[pt].reshape(B, -1, KV, hd).float()
    if k_scale is not None:
        k = k * k_scale[pt].repeat_interleave(page_size, dim=1)[:, :, None,
                                                                 None]
    if v_scale is not None:
        v = v * v_scale[pt].repeat_interleave(page_size, dim=1)[:, :, None,
                                                                None]
    qf = q.reshape(B, KV, H // KV, hd).float()
    return torch.einsum("bkgh,bskh->bkgs", qf, k) / (hd ** 0.5), v


def paged_attention_partials_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor, split_tokens: int,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None):
    """The per-split softmax states the CUDA paged kernel writes.

    A slot's context (its page table's width in tokens) is cut into
    ``n_split = ceil(max_pages * page_size / split_tokens)`` runs of
    ``split_tokens``; for each query row and split, over the split's
    tokens below the slot's length: ``m`` the max score (scores f32,
    divided by sqrt(hd)), ``l = sum exp(s - m)`` and ``acc = sum exp(s - m)
    v``.  A split with no such token has ``m = NEG_INF``, ``l = 0`` and
    ``acc = 0``.  Returns ``(m, l, acc)``: (B, H, n_split) f32 twice and
    (B, H, n_split, hd) f32."""
    B, H, hd = q.shape
    scores, v = _gathered_scores(q, k_pool, v_pool, page_table, k_scale,
                                 v_scale)
    ctx = scores.shape[-1]
    n_split = -(-ctx // split_tokens)
    pos = torch.arange(ctx, device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]  # (B, ctx)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        sl = slice(s * split_tokens, min((s + 1) * split_tokens, ctx))
        ok = valid[:, None, None, sl]                     # (B, 1, 1, n)
        sc = scores[..., sl].masked_fill(~ok, NEG_INF)    # (B, KV, g, n)
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m[..., None]) * ok
        ms.append(torch.where(ok.any(dim=-1), m, torch.full_like(m, NEG_INF)))
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskh->bkgh", p, v[:, sl]))
    m = torch.stack(ms, dim=-1).reshape(B, H, n_split)
    l = torch.stack(ls, dim=-1).reshape(B, H, n_split)
    acc = torch.stack(accs, dim=-2).reshape(B, H, n_split, hd)
    return m, l, acc


def merge_partials_ref(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Merge per-split softmax states (as
    :func:`paged_attention_partials_ref` returns them) into the attention
    output: rescale each split by ``exp(m_s - max m)``, skipping empty
    splits (``l = 0``), and divide by ``max(sum l, 1e-20)``.  Returns
    (B, H, hd) in ``dtype``."""
    live = l > 0
    mx = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(dim=-1,
                                                                keepdim=True)
    e = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
    lsum = (l * e).sum(dim=-1)
    out = torch.where(live[..., None], acc * e[..., None],
                      torch.zeros_like(acc)).sum(dim=-2)
    return (out / lsum.clamp(min=1e-20)[..., None]).to(dtype)
