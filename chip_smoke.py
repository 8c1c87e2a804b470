#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
and then, failing on the first phase that fails:

  1. holds the paged-attention kernel (each slot's context split across
     blocks, then merged) against its plain PyTorch version and against
     the plain model of the split (``paged_attention_partials_ref`` then
     ``merge_partials_ref``) at the llama3.2-3b attention geometry (24
     heads, 8 kv heads, head dim 128, 16-token pages, 8 slots, contexts
     up to 1152 tokens) for bf16, int8 and f32 pools, and times the
     kernel, the plain version and a library yardstick
     (``scaled_dot_product_attention`` on the context gathered
     beforehand, which the port never calls), with the achieved GB/s and
     the registers and shared memory of the variant launched;
  2. serves a mixed request stream through ``ContinuousServer`` in soup
     mode from a population of two full-width llama3.2-3b members (bf16,
     random weights from a seed), checking that every decode attention
     went through the kernel (launches == 28 x decode steps); then a short
     ensemble stream, a short int8-KV stream, and one teacher-forced decode
     step on the kernel path against the plain path;
  3. serves a stream at the reduced float32 config on the kernel path and
     on the plain path: greedy tokens must be identical; a server for a
     config of 9 query heads a kv head must be refused on the card, with
     the paged kernel's limit as the reason;
  4. holds the two WASH-shuffle kernels (dense and bucketed) bitwise
     against their plain versions for float32 and bfloat16 at N in
     {2, 3, 4, 8} on a leaf width that is a multiple of no block, and at
     the real stacked leaf ``blocks.mlp.w1`` with N = 4 (2.82e9 elements,
     past 2**31) and N = 2 (the bucketed kernel on the plans' ascending
     rows and on each row shuffled), then times each kernel, its plain
     version and a yardstick of library calls at the shapes its path
     gives it (device time: the calls captured in a CUDA graph and
     replayed), the bucketed one on both row orders, beside its bytes
     bound and its sector floor;
  5. trains full-width llama3.2-3b (28 layers, bf16, N = 2, SGD, bucketed
     WASH at p = 0.01, batch 2 x 256 tokens per member, 4 steps) through
     the train CLI's ``main``: every shuffle through the bucketed kernel
     (launches == 10 leaves x 4 steps) and each held bitwise against the
     plain version on the same inputs, the plans it applied sending
     exactly 9,016,867.0 scalars per member a step, one leaf's coordinate
     multisets unchanged by the shuffle, finite losses; then serves 4
     requests from the trained soup through ``ContinuousServer``, trains
     the same 4 steps again without the checks for the step's time split,
     tokens/s and peak memory, and profiles one more full-width training
     step (device time by operator, the device's busy share);
  6. trains llama3.2-3b at full width and 4 layers in float32 with dense
     WASH (the dense kernel) and with WASH+Opt under AdamW (the bucketed
     kernel on params, ``mu`` and ``nu``), once on the kernels and once
     on the plain versions: every shuffle bitwise equal, the final params
     within 1e-5; then the train CLI's ``--ckpt-population`` into the
     serve CLI's ``--ckpt`` at the reduced size;
  7. holds the flash-attention kernel against its plain version at the
     llama3.2-3b prefill shape (B=4, S=2048, 24 heads over 8 kv heads,
     head dim 128): bf16 and f32 causal, bf16 with a 512-token window,
     and a ragged S=1000 non-causal case; and the WKV kernel at the
     rwkv6-3b prefill shape (B=4, T=2048, 40 heads of 64) from zero and
     from a carried state (y and the final state), at T=1 (the step
     kernel), with bf16 inputs, and with extreme decays (w = exp(-exp(x)),
     x over [-8, 6], exact 0s and 1 - 2**-24; every value finite); then
     times each kernel (WKV also at the decode shape, T=1: two input
     sets cycled, and a decode step's 32 layers' calls), its plain
     version and, for flash, ``scaled_dot_product_attention`` (which the
     port never calls), with flash's achieved TFLOP/s (f32 against both
     the 3xTF32 and the FFMA rate) and the registers and shared memory of
     each variant launched (flash bf16: wgmma on the tensor cores,
     TMA-fed; flash f32: 3xTF32 mma.sync, cp.async-fed, its TF32 mma
     counted in the library's SASS; WKV: the chunked kernel, 3xTF32
     mma.sync, TMA-fed, and the step kernel); then the WKV backward
     (training, f32; three launches: the chunk walks, every chunk's grads,
     du) against its plain version, every grad within 1e-4 of max |plain|
     and finite: at rwkv6-3b's training shape (B=2, T=256, 40 heads of 64)
     from zero, at the prefill shape from a carried state with a
     final-state grad, with extreme decays, at a ragged T=1000 and at hd
     32, and at the training shape also against the plain model of its
     arithmetic (``rwkv6_scan_bwd_chunked_ref``); timed at both shapes, the
     whole call (CUDA-graph replays) and each launch (``torch.profiler``),
     beside its bound (the bytes the function moves, or its operations at
     the f32 peak), the design's own traffic (the chunks' S_in and G_out,
     the walks' second reads), its plain version's time, and each kernel's
     registers, shared memory and spills;
  8. serves full-width rwkv6-3b (32 layers, bf16) and llama3.2-3b (28
     layers, bf16) from random N=2 populations through the serve CLI's
     scan engine (``--compare``: soup, member and ensemble, B=4, S=2048,
     32 new tokens), checking that every rwkv6 time mix went through the
     WKV kernel (launches == requests x 32 layers x members x (1 prefill
     + 31 decode steps)) and every llama prefill attention through the
     flash kernel (launches == requests x 28 x members); one teacher-forced
     prefill + decode step per model on the kernel path against the plain
     path (logits, and every layer's rwkv6 state); then the reduced
     float32 rwkv6 and llama through ``engine.generate`` on the kernel and
     plain paths: greedy tokens identical; rwkv6 at rwkv_head_dim=16 must
     be refused on the card, with the WKV kernel's head dims as the
     reason.
  9. trains full-width rwkv6-3b (32 layers, bf16, N = 2, SGD, bucketed
     WASH at p = 0.01, 2 x 256 tokens per member, 4 steps) through the
     train CLI's ``main``: every time mix through the WKV kernel forward
     and its backward kernel (launches == 32 x 2 x 4 each), every shuffle
     held bitwise against its plain version, the plans it applied sending
     exactly ``static_mix_comm`` scalars a step, finite losses; serves the
     trained soup through the scan engine; trains the same 4 steps again
     without the checks for the step's split, tokens/s and peak memory, and
     profiles one more full-width training step (with the WKV backward's
     device time: ``_RWKV6ScanBackward`` and each of its kernels);
     then trains the reduced float32 rwkv6 3 steps on the kernels and on
     the plain versions (final params within 1e-5), and takes its train
     CLI ``--ckpt-population`` through the serve CLI's ``--ckpt``.

Kernels are built from the sources in the checkout, each ``nvcc`` started
at once.  It prints one JSON line ``{"kernels": [...]}``, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# tolerances of the kernel against its plain version, per (q, pool) dtype:
# both accumulate in f32; bf16 outputs differ by the final rounding
# (one bf16 ulp is 2**-8 relative), f32 and int8 outputs by summation order
KERNEL_TOL = {"bf16": 2e-2, "int8": 2e-2, "f32": 2e-5}

# phase 6: params after 3 float32 steps on the kernels against the plain
# versions; the shuffles are bitwise, but the embedding's backward adds
# with atomics, in an order that changes from run to run
PARAM_TOL = 1e-5

# full-width bf16 logits, kernel path against plain path after one decode
# step through 28 layers: bf16 rounding of each layer's attention output
# compounds, so the bound is relative to the logits' range
LOGIT_REL_TOL = 5e-2

# published H100 SXM peaks (NVIDIA data sheet, dense): memory rate and the
# operation rate for the type the kernel computes in.  float32 at float32
# accuracy runs fastest through 3xTF32 on the tensor cores (three TF32
# products for one float32 product), so its peak is the dense TF32 rate
# over 3, not the CUDA cores' FFMA rate (67 TFLOP/s), which a 3xTF32
# kernel can beat
HBM_BYTES_PER_S = 3.35e12
TF32_OPS = 494.7e12
FFMA_OPS = 67e12
PEAK_OPS = {"bf16": 989e12, "f32": TF32_OPS / 3, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def device_ms(torch, fn, n_layers: int, reps: int = 20) -> float:
    """Device time of one ``fn(layer)`` call: the calls for all layers are
    captured in one CUDA graph and replayed, so the host's launch overhead
    is out of the measurement; the layers are cycled, each call reading a
    layer the previous ``n_layers - 1`` did not (more bytes than L2 holds).
    CUDA events around ``reps`` replays, mean per call."""
    for i in range(n_layers):  # warm-up, outside the capture
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_layers):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n_layers)


def wall_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Time of one eager ``fn()`` call as the caller sees it (host launch
    overhead included): CUDA events around ``iters`` calls, mean."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: the kernel against its plain version
# ---------------------------------------------------------------------------

H, KV, HD, PAGE, SLOTS = 24, 8, 128, 16, 8
LENGTHS = [1, 16, 17, 255, 512, 800, 1024, 1152]  # edges: 1, page, page+1
LAYERS = 28


def kernel_inputs(torch, variant: str, device):
    """28 layers of pools at the slice's geometry, random page tables (the
    entries past each length point at arbitrary pages), this variant's
    q and pool dtypes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    max_pages = -(-max(LENGTHS) // PAGE)
    P = SLOTS * max_pages + 1
    perm = torch.randperm(P - 1, generator=gen, device=device) + 1
    table = perm[:SLOTS * max_pages].reshape(SLOTS, max_pages).to(torch.int32)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=device)
    qdt = torch.float32 if variant == "f32" else torch.bfloat16
    q = torch.randn(LAYERS, SLOTS, H, HD, generator=gen, device=device).to(qdt)
    shape = (LAYERS, P, PAGE, KV, HD)
    k = torch.randn(shape, generator=gen, device=device)
    v = torch.randn(shape, generator=gen, device=device)
    if variant == "int8":
        ks = k.abs().amax(dim=(2, 3, 4)) / 127.0
        vs = v.abs().amax(dim=(2, 3, 4)) / 127.0
        k = torch.round(k / ks[:, :, None, None, None]).clamp(-127, 127)
        v = torch.round(v / vs[:, :, None, None, None]).clamp(-127, 127)
        return (q, k.to(torch.int8), v.to(torch.int8), table, lengths,
                ks.contiguous(), vs.contiguous())
    return q, k.to(qdt), v.to(qdt), table, lengths, None, None


def work_of(variant: str, q, lengths, scales: bool):
    """Bytes the function must move and operations it must do for this
    call's data: each needed input element read once, the output written
    once (K/V: only the rows below each slot's length)."""
    tokens = int(lengths.sum())
    kv_elem = {"bf16": 2, "f32": 4, "int8": 1}[variant]
    q_elem = 4 if variant == "f32" else 2
    pages = sum(-(-n // PAGE) for n in lengths.tolist())
    nbytes = (2 * tokens * KV * HD * kv_elem      # K and V rows
              + 2 * SLOTS * H * HD * q_elem       # q in, out
              + 4 * (pages + SLOTS)               # page-table entries, lengths
              + (8 * pages if scales else 0))     # k/v scales of used pages
    ops = 4 * tokens * H * HD                     # QK^T and PV, mul+add each
    return nbytes, ops


def attributes_line(attrs: dict) -> str:
    return ", ".join(f"{v} {k.replace('_', ' ')}" for k, v in attrs.items())


def check_kernel(torch, pa, ref, F, device):
    """Phase 1.  Returns the kernel entries of the JSON line (launches
    filled in later from the main-path runs)."""
    entries = {}
    split_tokens, n_split = pa.split_of(PAGE, -(-max(LENGTHS) // PAGE))
    for variant in ("bf16", "int8", "f32"):
        q, k, v, table, lengths, ks, vs = kernel_inputs(torch, variant, device)
        err = err_split = 0.0
        for layer in (0, LAYERS - 1):
            args = (q[layer], k[layer], v[layer], table, lengths)
            scales = {} if ks is None else dict(k_scale=ks[layer],
                                                v_scale=vs[layer])
            got = pa.paged_attention_cuda(*args, **scales)
            want = ref.paged_attention_ref(*args, **scales)
            split = ref.merge_partials_ref(
                *ref.paged_attention_partials_ref(*args, split_tokens,
                                                  **scales), q.dtype)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                fail(f"{variant}: kernel output is not finite")
            err = max(err, float((got.float() - want.float()).abs().max()))
            err_split = max(err_split,
                            float((got.float() - split.float()).abs().max()))
        tol = KERNEL_TOL[variant]
        log(f"kernel {variant}: max |kernel - plain| = {err:.3e}, max "
            f"|kernel - plain split model| = {err_split:.3e} ({n_split} "
            f"splits of {split_tokens} tokens; tolerance {tol:g}), lengths "
            f"{LENGTHS}")
        if err > tol or err_split > tol:
            fail(f"paged attention {variant} disagrees with its plain "
                 f"version: {err}, split model {err_split} > {tol}")
        vec = pa.load_width(k[0], v[0], H // KV)
        attrs = pa.kernel_attributes(q.dtype, k.dtype, H, KV, HD, vec)
        log(f"kernel {variant}: split kernel launched with {vec}-element "
            f"loads: {attributes_line(attrs)}")

        def run_kernel(layer):
            pa.paged_attention_cuda(
                q[layer], k[layer], v[layer], table, lengths,
                None if ks is None else ks[layer],
                None if vs is None else vs[layer])

        def run_plain(layer):
            ref.paged_attention_ref(
                q[layer], k[layer], v[layer], table, lengths,
                None if ks is None else ks[layer],
                None if vs is None else vs[layer])

        # library yardstick: SDPA over each slot's context gathered and
        # dequantized beforehand (outside the timed region)
        ctx = table.shape[1] * PAGE
        lib_dtype = q.dtype
        kk = k[:, table.long()].reshape(LAYERS, SLOTS, ctx, KV, HD)
        vv = v[:, table.long()].reshape(LAYERS, SLOTS, ctx, KV, HD)
        if ks is not None:
            kk = kk.float() * ks[:, table.long()].repeat_interleave(
                PAGE, dim=2)[..., None, None]
            vv = vv.float() * vs[:, table.long()].repeat_interleave(
                PAGE, dim=2)[..., None, None]
        kk = kk.to(lib_dtype).transpose(2, 3).contiguous()  # (L,B,KV,ctx,hd)
        vv = vv.to(lib_dtype).transpose(2, 3).contiguous()
        qq = q.to(lib_dtype)[:, :, :, None, :]               # (L,B,H,1,hd)
        mask = (torch.arange(ctx, device=device)[None, :]
                < lengths[:, None])[:, None, None, :]       # (B,1,1,ctx)

        def run_library(layer):
            F.scaled_dot_product_attention(qq[layer], kk[layer], vv[layer],
                                           attn_mask=mask, enable_gqa=True)

        n0 = pa.launches
        ms = device_ms(torch, run_kernel, LAYERS)
        plain_ms = device_ms(torch, run_plain, LAYERS)
        library_ms = device_ms(torch, run_library, LAYERS)
        ms2 = device_ms(torch, run_kernel, LAYERS)
        launch_ms = wall_ms(torch, lambda: run_kernel(0), iters=112)
        pa.launches = n0  # comparison launches do not count
        nbytes, ops = work_of(variant, q[0], lengths, ks is not None)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[variant] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"kernel {variant}: {ms:.4f} ms on the device, a call's two "
            f"launches (again {ms2:.4f}; {launch_ms:.4f} ms a call through "
            f"the Python wrapper), plain {plain_ms:.4f} ms, library (SDPA) "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes} B, {ops} ops); achieved "
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
        entries[variant] = {
            "name": f"paged_attention[q={'f32' if variant == 'f32' else 'bf16'}"
                    f",kv={variant}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:106",
            "launches": 0,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        }
        del q, k, v, kk, vv, qq
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phases 2 and 3: the slice through the port's entry points
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_routes(ops, ref, *names):
    """Route each named op of ``kernels.ops`` (``paged_attention``,
    ``flash_attention``, ``rwkv6_scan``) through its plain version for the
    block (the comparison path; the kernels' counters do not move)."""
    kernel_routes = {name: getattr(ops, name) for name in names}
    for name in names:
        setattr(ops, name, getattr(ref, f"{name}_ref"))
    try:
        yield
    finally:
        for name, route in kernel_routes.items():
            setattr(ops, name, route)


def check_results(out, reqs, vocab: int, what: str):
    if set(out) != {r.uid for r in reqs}:
        fail(f"{what}: served {len(out)} of {len(reqs)} requests")
    for r in reqs:
        toks = out[r.uid].tokens
        if toks.shape != (len(r.tokens) + r.max_new,):
            fail(f"{what}: request {r.uid} has {toks.shape} tokens")
        if (toks[:len(r.tokens)] != r.tokens).any():
            fail(f"{what}: request {r.uid} lost its prompt")
        if toks.min() < 0 or toks.max() >= vocab:
            fail(f"{what}: request {r.uid} sampled out of the vocabulary")


def serve_stream(torch, pa, server, reqs, what, n_layers, n_members=1):
    """Serve ``reqs`` with the launch count zeroed just before and read
    just after; checks launches == layers x members x decode steps."""
    steps0 = server.stats["decode_steps"]
    torch.cuda.synchronize()
    pa.launches = 0
    t0 = time.perf_counter()
    out = server.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = pa.launches
    steps = server.stats["decode_steps"] - steps0
    new_tokens = sum(r.max_new for r in reqs)
    st = server.stats
    log(f"{what}: {len(reqs)} requests, {new_tokens} new tokens in {dt:.3f} s "
        f"= {new_tokens / dt:.2f} tok/s; prompt tokens prefilled "
        f"{st['prefill_tokens']} (prefix reused {st['prefix_tokens_reused']}); "
        f"decode steps {steps}; pages allocated {st['pages_allocated']}, "
        f"shared {st['pages_shared']}, peak {st['peak_pages_in_use']}; "
        f"kernel launches {launches} (expected {n_layers}x{n_members}x{steps})")
    check_results(out, reqs, server.cfg.vocab_size, what)
    if steps == 0 or launches != n_layers * n_members * steps:
        fail(f"{what}: {launches} kernel launches for {steps} decode steps "
             f"of {n_layers} layers x {n_members} members")
    if server._pool.used_count:
        fail(f"{what}: {server._pool.used_count} pages still held")
    return out, launches


def full_width(torch, device, kernels):
    from repro_torch.configs import get_arch
    from repro_torch.core import population as pop
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import init_population, mixed_stream
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as M
    from repro_torch.serving import batching as B
    from repro_torch.serving.engine import averaged_params

    cfg = get_arch("llama3.2-3b")
    t0 = time.perf_counter()
    popn = init_population(cfg, 2, seed=0, device=device)
    soup = averaged_params(popn)
    torch.cuda.synchronize()
    n_params = pop.num_params(soup)
    log(f"full width: {cfg.name} {cfg.num_layers} layers d_model "
        f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} head_dim "
        f"{cfg.resolved_head_dim} vocab {cfg.vocab_size} {cfg.dtype}; "
        f"{n_params} params per member; population of 2 + soup built in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    geo = dict(page_size=16, max_slots=8, num_pages=320,
               max_pages_per_slot=-(-(512 + 32) // 16), device=device)
    server = B.ContinuousServer(soup, cfg, mode="soup", **geo)
    # warm-up (cuBLAS handles, allocator): two requests, not measured
    server.run(mixed_stream(cfg, 2, 64, 4, seed=99))
    reqs = mixed_stream(cfg, 16, 512, 32, seed=0, share_prefix_every=4)
    _, launches = serve_stream(torch, pa, server, reqs,
                               "soup stream (full width)", cfg.num_layers)
    kernels["bf16"]["launches"] = launches

    ens = B.ContinuousServer.from_trained(popn, cfg, mode="ensemble", **geo)
    serve_stream(torch, pa, ens, mixed_stream(cfg, 6, 256, 8, seed=1),
                 "ensemble stream (full width, N=2)", cfg.num_layers, 2)
    del ens

    q8 = B.ContinuousServer(soup, cfg, mode="soup", kv_dtype="int8", **geo)
    _, launches = serve_stream(
        torch, pa, q8,
        mixed_stream(cfg, 8, 512, 16, seed=2, share_prefix_every=4),
        "int8-KV soup stream (full width)", cfg.num_layers)
    kernels["int8"]["launches"] = launches
    del q8

    # one decode step at the stream's batch (8 slots, 512-token contexts),
    # kernel path and plain path, timed alone (launches here do not count)
    n_pages = geo["max_pages_per_slot"]
    pools = L.paged_pools_init(cfg, 8 * n_pages + 1, 16, cfg.num_layers,
                               device=device)
    tables = torch.arange(1, 8 * n_pages + 1, dtype=torch.int32,
                          device=device).reshape(8, n_pages)
    positions = torch.full((8,), 511, dtype=torch.int32, device=device)
    tokens = torch.arange(8, dtype=torch.int32, device=device)

    def step():
        M.decode_step_paged(soup, cfg, tokens, positions, pools, tables)

    step_ms = wall_ms(torch, step)
    with plain_routes(ops, ref, "paged_attention"):
        plain_step_ms = wall_ms(torch, step)
    pa.launches = 0
    log(f"decode step (full width, 8 slots at 512 tokens, eager, host "
        f"overhead included): {step_ms:.3f} ms "
        f"with the kernel = {8 / step_ms * 1e3:.1f} tok/s; {plain_step_ms:.3f}"
        f" ms with the plain attention")
    del pools

    # one teacher-forced decode step, kernel path against plain path, on
    # identical copies of a prefilled pool
    pools = L.paged_pools_init(cfg, 40, 16, cfg.num_layers, device=device)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, 300).astype(np.int32)).to(device)
    table = torch.arange(1, 21, dtype=torch.int32, device=device)
    lg, pools = M.prefill_paged(soup, cfg, prompt, 0, pools, table)
    tok = lg[:, -1].argmax(-1).to(torch.int32)
    pos = torch.tensor([300], dtype=torch.int32, device=device)
    copy = {s: pools[s].clone() for s in pools}
    pa.launches = 0
    with_kernel, _ = M.decode_step_paged(soup, cfg, tok, pos, pools,
                                         table[None])
    if pa.launches != cfg.num_layers:
        fail(f"teacher-forced step made {pa.launches} kernel launches")
    with plain_routes(ops, ref, "paged_attention"):
        plain, _ = M.decode_step_paged(soup, cfg, tok, pos, copy, table[None])
    torch.cuda.synchronize()
    diff = float((with_kernel.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    log(f"teacher-forced decode step (full width, bf16): max |logit "
        f"kernel - plain| = {diff:.4e}, max |logit| = {scale:.4e}, "
        f"tolerance {LOGIT_REL_TOL:g} x max |logit|; argmax "
        f"{int(with_kernel.argmax())} vs {int(plain.argmax())}")
    if not torch.isfinite(with_kernel.float()).all():
        fail("full-width logits are not finite")
    if diff > LOGIT_REL_TOL * scale:
        fail(f"full-width logits: kernel path differs from plain by {diff}")
    del popn, soup, server, pools, copy
    torch.cuda.empty_cache()


def refused(what, fn, limit: str) -> None:
    """A run on the card that the kernels cannot take is refused up front
    (``transformer.cuda_supported``), with a reason naming the limit."""
    try:
        fn()
    except NotImplementedError as e:
        if limit not in str(e):
            fail(f"{what}: refused without naming the limit {limit!r}: {e}")
        log(f"{what}: refused on the card, as it must be: {e}")
        return
    fail(f"{what}: not refused on the card")


def reduced_f32(torch, device, kernels):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import init_population, mixed_stream
    from repro_torch.serving import batching as B
    from repro_torch.serving.engine import averaged_params

    cfg = get_arch("llama3.2-3b").reduced()
    soup = averaged_params(init_population(cfg, 2, seed=3, device=device))
    geo = dict(page_size=8, max_slots=4, num_pages=128, device=device)
    reqs = mixed_stream(cfg, 12, 48, 12, seed=4, share_prefix_every=3)
    out_k, launches = serve_stream(
        torch, pa, B.ContinuousServer(soup, cfg, prefill_chunk=16, **geo),
        reqs, "reduced f32 stream, kernel path", cfg.num_layers)
    kernels["f32"]["launches"] = launches
    with plain_routes(ops, ref, "paged_attention"):
        plain_server = B.ContinuousServer(soup, cfg, prefill_chunk=16, **geo)
        out_p = plain_server.run(reqs)
    same = all((out_k[r.uid].tokens == out_p[r.uid].tokens).all()
               for r in reqs)
    log(f"reduced f32: greedy tokens kernel path == plain path: {same}")
    if not same:
        fail("reduced f32 greedy tokens differ between kernel and plain path")
    group9 = dataclasses.replace(cfg, num_heads=9, num_kv_heads=1,
                                 head_dim=64)
    refused("ContinuousServer at 9 query heads a kv head",
            lambda: B.ContinuousServer(soup, group9, **geo),
            f"at most {pa.MAX_GROUP}")


# ---------------------------------------------------------------------------
# phase 4: the shuffle kernels against their plain versions
# ---------------------------------------------------------------------------

ODD_D = 1_000_003                       # a multiple of no block size
W1_LAYERS, W1_REST = 28, 3072 * 8192    # blocks.mlp.w1 of llama3.2-3b
W1_D = W1_LAYERS * W1_REST              # its scalars per member


def _bits(torch, x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _same(torch, a, b) -> bool:
    """The shuffle kernels only move data: held bit for bit (tolerance:
    none, max |diff| == 0)."""
    return a.shape == b.shape and torch.equal(_bits(torch, a), _bits(torch, b))


def _cyclic_perm(torch, n, d, device, seed):
    """(n, d) int32 columns that are permutations (random cyclic shifts),
    drawn without the (n, d) argsort a dense plan would take."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shift = torch.randint(0, n, (d,), generator=gen, device=device,
                          dtype=torch.int32)
    return (torch.arange(n, dtype=torch.int32, device=device)[:, None]
            + shift) % n


def _randn(torch, n, d, dtype, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(n, d, generator=gen, device=device).to(dtype)


def _w1_plan(shf, sch, n, device):
    """The bucketed plan the training path draws for blocks.mlp.w1."""
    p_vec = sch.layer_probability_array(0.01, np.arange(1, W1_LAYERS + 1),
                                        W1_LAYERS + 2, "decreasing")
    return shf.bucketed_plan_layered(0, W1_LAYERS, W1_REST, n, p_vec,
                                     device=device)


def shuffle_bytes_dense(n, d, elt, mask_count):
    """x read and out written once, the mask once, perm only where the
    mask is set (the function needs no other perm entry)."""
    return 2 * n * d * elt + d + 4 * n * mask_count


def shuffle_bytes_bucketed(n, k_per, elt):
    """Each selected column of buckets 1..N-1 read and written once (N
    values each), plus its plan entry."""
    return 2 * n * (n - 1) * k_per * elt + 4 * (n - 1) * k_per


def shuffle_sector_floor_bytes(n, k_per):
    """What the scattered accesses cost at best: the selected columns lie
    ~1/p apart, so no two share a 32-byte sector, and each of the N
    values of a column costs a sector read and a sector written, plus the
    column's plan entry."""
    return (n - 1) * k_per * (2 * n * 32 + 4)


def _shuffled_rows(torch, idx, seed):
    """A copy of a bucketed plan with every row in a random order: the
    rows stay disjoint, so it moves the same bits as the plan."""
    gen = _gen(torch, idx.device, seed)
    return torch.stack([row[torch.randperm(row.numel(), generator=gen,
                                           device=idx.device)]
                        for row in idx]).contiguous()


def check_shuffle_kernels(torch, device):
    """Phase 4.  Returns the two kernels' entries of the JSON line (their
    launches filled in later from the training runs), each with the worst
    |kernel - plain| of its checks.  Times are device times per call
    (``device_ms``: CUDA-graph replay, no host launch overhead)."""
    from repro_torch.core import schedules as sch
    from repro_torch.core import shuffle as shf
    from repro_torch.kernels import ref
    from repro_torch.kernels import wash_shuffle as ws

    err = {"dense": 0.0, "bucketed": 0.0}

    def hold(kind, got, want, what):
        """Bitwise, or the phase fails; the float |diff| is also taken
        where a float copy is cheap (below 2**28 elements)."""
        if got.numel() < 2 ** 28:
            err[kind] = max(err[kind],
                            float((got.float() - want.float()).abs().max()))
        if not _same(torch, got, want):
            fail(f"{kind} shuffle kernel differs from its plain version "
                 f"({what})")

    d = ODD_D
    for n in (2, 3, 4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            x = _randn(torch, n, d, dtype, device, seed=n)
            perm, mask = shf.dense_plan(n, (d,), n, 0.3, device)  # seed n
            hold("dense", ws.wash_shuffle_cuda(x, perm, mask),
                 ref.wash_shuffle_ref(x, perm, mask), f"N={n} {dtype} D={d}")
            idx = shf.bucketed_plan(n, d, n, 0.3, device=device)
            want = ref.bucketed_shuffle_ref(x, idx)
            hold("bucketed", ws.bucketed_shuffle_cuda_(x.clone(), idx),
                 want, f"N={n} {dtype} D={d}")
            hold("bucketed", ws.bucketed_shuffle_cuda_(
                x.clone(), _shuffled_rows(torch, idx, n)), want,
                f"N={n} {dtype} D={d}, rows shuffled")
    torch.cuda.synchronize()
    log(f"shuffle kernels: bitwise equal to their plain versions for "
        f"float32 and bfloat16 at N in (2, 3, 4, 8), D = {d} (bucketed: "
        f"on the ascending rows the plans draw and on each row shuffled)")

    w1_d = W1_D
    # the real stacked leaf, N = 4: 2.82e9 bf16 elements
    n = 4
    x = _randn(torch, n, w1_d, torch.bfloat16, device, seed=40)
    idx = _w1_plan(shf, sch, n, device)
    want = x.clone()
    ref.bucketed_shuffle_ref_(want, idx)
    ws.bucketed_shuffle_cuda_(x, idx)
    torch.cuda.synchronize()
    hold("bucketed", x, want, f"blocks.mlp.w1 N={n}")
    x2 = _randn(torch, n, w1_d, torch.bfloat16, device, seed=40)
    ws.bucketed_shuffle_cuda_(x2, _shuffled_rows(torch, idx, 42))
    torch.cuda.synchronize()
    hold("bucketed", x2, want, f"blocks.mlp.w1 N={n}, rows shuffled")
    del want, x2
    perm = _cyclic_perm(torch, n, w1_d, device, seed=41)
    mask = torch.rand(w1_d, device=device) < 0.01
    got = ws.wash_shuffle_cuda(x, perm, mask)
    want = ref.wash_shuffle_ref(x, perm, mask)
    torch.cuda.synchronize()
    hold("dense", got, want, f"blocks.mlp.w1 N={n}")
    del want, got
    torch.cuda.empty_cache()
    t_b = device_ms(torch, lambda _: ws.bucketed_shuffle_cuda_(x, idx), 1, 10)
    t_d = device_ms(torch, lambda _: ws.wash_shuffle_cuda(x, perm, mask), 1, 5)
    log(f"blocks.mlp.w1 at N={n} ({n * w1_d} bf16 elements, past 2**31): "
        f"both kernels bitwise equal to their plain versions; device time "
        f"bucketed {t_b:.4f} ms (plan ({n}, {idx.shape[1]})), dense "
        f"{t_d:.4f} ms (mask 1%)")
    del x, idx, perm, mask
    torch.cuda.empty_cache()

    # timing at the shapes the main paths give each kernel
    entries = {}
    x = _randn(torch, 2, w1_d, torch.bfloat16, device, seed=50)
    idx = _w1_plan(shf, sch, 2, device)
    k_per = idx.shape[1]
    want = ref.bucketed_shuffle_ref(x, idx)  # the path's N = 2, held once
    hold("bucketed", ws.bucketed_shuffle_cuda_(x, idx), want,
         f"blocks.mlp.w1 N=2 plan (2, {k_per})")
    del want
    cols = idx[1:].reshape(-1).long()
    buckets = torch.arange(1, 2, device=device).repeat_interleave(k_per)
    src = (torch.arange(2, device=device)[:, None] + buckets) % 2
    # (member n of bucket s's columns takes member n+s's value)
    n0 = ws.bucketed_launches

    def yard_b():
        x.index_copy_(1, cols, x.index_select(1, cols).gather(0, src))

    shuffled = _shuffled_rows(torch, idx, 51)
    # 100 replays a reading: 20 of a ~0.3 ms call varied by ~0.03 ms
    ms = device_ms(torch, lambda _: ws.bucketed_shuffle_cuda_(x, idx), 1, 100)
    plain_ms = device_ms(torch, lambda _: ref.bucketed_shuffle_ref_(x, idx), 1)
    yard_ms = device_ms(torch, lambda _: yard_b(), 1)
    shuffled_ms = device_ms(
        torch, lambda _: ws.bucketed_shuffle_cuda_(x, shuffled), 1, 100)
    ms2 = device_ms(torch, lambda _: ws.bucketed_shuffle_cuda_(x, idx), 1, 100)
    call_ms = wall_ms(torch, lambda: ws.bucketed_shuffle_cuda_(x, idx), 20, 2)
    ws.bucketed_launches = n0  # comparison launches do not count
    nbytes = shuffle_bytes_bucketed(2, k_per, 2)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    floor_bytes = shuffle_sector_floor_bytes(2, k_per)
    floor_ms = floor_bytes / HBM_BYTES_PER_S * 1e3
    log(f"bucketed shuffle, blocks.mlp.w1 N=2 bf16, plan (2, {k_per}), "
        f"device time: kernel {ms:.4f} ms on the plan's ascending rows "
        f"(again {ms2:.4f}; {call_ms:.4f} ms a call through the Python "
        f"wrapper), {shuffled_ms:.4f} ms on the same rows shuffled, plain "
        f"{plain_ms:.4f} ms, yardstick index_select+gather+index_copy_ "
        f"{yard_ms:.4f} ms (no single PyTorch call computes the function), "
        f"bound {bound:.4f} ms by bytes ({nbytes} B), sector floor "
        f"{floor_ms:.4f} ms ({floor_bytes} B: a 32-byte sector read and "
        f"written a value); achieved {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
        f"of the bytes it needs, {floor_bytes / (ms * 1e-3) / 1e9:.1f} GB/s "
        f"of sectors")
    entries["bucketed"] = {
        "name": "bucketed_shuffle[bf16,N=2,blocks.mlp.w1]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wash_shuffle.cu",
        "replaces": "src/repro/kernels/wash_shuffle.py:75",
        "launches": 0, "max_abs_err": err["bucketed"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": None, "yardstick_ms": yard_ms,
        "shuffled_rows_ms": shuffled_ms}
    del x, idx, cols, src, shuffled
    torch.cuda.empty_cache()

    # the dense path: phase 6's blocks.mlp.w1, float32, N = 2
    layers = REDUCED_LAYERS
    x = _randn(torch, 2, layers * W1_REST, torch.float32, device, seed=60)
    p_vec = sch.layer_probability_array(0.01, np.arange(1, layers + 1),
                                        layers + 2, "decreasing")
    perm, mask = shf.dense_plan_layered(61, (layers, W1_REST), 2, p_vec,
                                        device)
    perm, mask = perm.reshape(2, -1), mask.reshape(-1)
    perm64 = perm.long()
    n0 = ws.wash_launches
    ms = device_ms(torch, lambda _: ws.wash_shuffle_cuda(x, perm, mask), 1)
    plain_ms = device_ms(torch, lambda _: ref.wash_shuffle_ref(x, perm, mask),
                         1)
    yard_ms = device_ms(torch, lambda _: torch.where(
        mask, torch.gather(x, 0, perm64), x), 1)
    ms2 = device_ms(torch, lambda _: ws.wash_shuffle_cuda(x, perm, mask), 1)
    call_ms = wall_ms(torch, lambda: ws.wash_shuffle_cuda(x, perm, mask), 20, 2)
    ws.wash_launches = n0
    nnz = int(mask.sum())
    nbytes = shuffle_bytes_dense(2, x.shape[1], 4, nnz)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"dense shuffle, blocks.mlp.w1 at {layers} layers N=2 f32 ({nnz} of "
        f"{x.shape[1]} columns masked), device time: kernel {ms:.4f} ms "
        f"(again {ms2:.4f}; {call_ms:.4f} ms a call through the Python "
        f"wrapper), plain {plain_ms:.4f} ms, yardstick gather+where on an "
        f"int64 perm {yard_ms:.4f} ms (no single PyTorch call computes the "
        f"function), "
        f"bound {bound:.4f} ms by bytes ({nbytes} B); achieved "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    entries["dense"] = {
        "name": "wash_shuffle[f32,N=2,blocks.mlp.w1 at 4 layers]",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/wash_shuffle.cu",
        "replaces": "src/repro/kernels/wash_shuffle.py:40",
        "launches": 0, "max_abs_err": err["dense"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": None, "yardstick_ms": yard_ms}
    del x, perm, mask, perm64
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phases 5 and 9: full-width training, then the trained soup served
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_SEQ = 4, 256    # phases 5, 9: steps, tokens a sequence
# per arch trained at full width: the leaves that get a plan, and the
# scalars sent per member a mixing step (also its static_mix_comm)
TRAIN_PLANS = {"llama3.2-3b": (10, 9016867.0), "rwkv6-3b": (18, 7670170.0)}


@contextlib.contextmanager
def checked_shuffles(ops, ref, torch, counts):
    """Every shuffle on the kernel route is also run through the plain
    version on the same inputs and must be bitwise equal; ``counts``
    tallies the comparisons (the kernels' launch counters move as they
    would without the check)."""
    dense, bucketed = ops.wash_shuffle, ops.bucketed_shuffle_

    def dense_checked(x, perm, mask):
        out = dense(x, perm, mask)
        if not _same(torch, out, ref.wash_shuffle_ref(x, perm, mask)):
            fail("training: a dense shuffle differs from its plain version")
        counts["dense"] += 1
        return out

    def bucketed_checked(x, idx):
        want = ref.bucketed_shuffle_ref(x, idx)
        bucketed(x, idx)
        if not _same(torch, x, want):
            fail("training: a bucketed shuffle differs from its plain version")
        counts["bucketed"] += 1
        return x

    ops.wash_shuffle, ops.bucketed_shuffle_ = dense_checked, bucketed_checked
    try:
        yield
    finally:
        ops.wash_shuffle, ops.bucketed_shuffle_ = dense, bucketed


@contextlib.contextmanager
def watch_bucketed_shuffles(ops, width, seen):
    """Record the shape of every plan the bucketed route applies, and keep
    a copy of the first stacked leaf of ``width`` columns it shuffles,
    before and after (observation only: the shuffle runs as it would)."""
    route = ops.bucketed_shuffle_

    def watched(x, idx):
        seen["plans"].append(tuple(idx.shape))
        if "before" in seen or x.shape[1] != width:
            return route(x, idx)
        seen["before"] = x.clone()
        out = route(x, idx)
        seen["after"] = x.clone()
        return out

    ops.bucketed_shuffle_ = watched
    try:
        yield
    finally:
        ops.bucketed_shuffle_ = route


def training_argv(arch: str, device) -> list:
    """The train CLI's arguments of phases 5 and 9: N = 2, SGD, bucketed
    WASH at p = 0.01, 2 x TRAIN_SEQ tokens a member, TRAIN_STEPS steps."""
    return ["--arch", arch, "--population", "2", "--mixing", "wash",
            "--mode", "bucketed", "--base-p", "0.01", "--optimizer", "sgd",
            "--steps", str(TRAIN_STEPS), "--batch-size", "2", "--seq-len",
            str(TRAIN_SEQ), "--record-every", "1", "--lr", "0.01",
            "--device", str(device)]


def comm_per_step(seen, history, n: int, per_step: int):
    """The comm of the plans the bucketed route applied (idx.numel() (N -
    1) / N a launch, ``per_step`` consecutive launches a step) and the
    comm the loop recorded, each per step."""
    sent = [k_n * k_per * (n - 1) / n for k_n, k_per in seen["plans"]]
    applied = [sum(sent[i:i + per_step]) for i in range(0, len(sent),
                                                         per_step)]
    return applied, np.diff([0.0] + history["comm"]).tolist()


def timed_training_run(torch, train_cli, argv, what: str) -> None:
    """The train CLI once more without the checks: the step's split,
    tokens/s and peak memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = TRAIN_STEPS
    tokens = steps * 2 * 2 * TRAIN_SEQ
    ph = {p: res.phase_ms[p] for p in ("fwd_bwd", "opt", "mix")}
    log(f"{what} step split, the same run without checks (CUDA events, "
        f"ms per step, both members): forward+backward {ph['fwd_bwd']}, "
        f"optimizer {ph['opt']}, mixing {ph['mix']}; trained {tokens} tokens "
        f"in {wall:.2f} s = {tokens / wall:.1f} tokens/s (population built "
        f"and first step included); steps 2.. mean "
        f"{sum(sum(ph[p][1:]) for p in ph) / max(steps - 1, 1):.1f} ms in "
        f"the three phases; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def train_full_width(torch, device, arch, kernels):
    """Phases 5 (llama3.2-3b) and 9 (rwkv6-3b): the arch at full width
    through the train CLI's ``main`` (``training_argv``), every shuffle
    held bitwise against its plain version.  Checks the bucketed launches
    (``TRAIN_PLANS`` leaves a step), the comm the applied plans send a
    step (``TRAIN_PLANS`` and ``static_mix_comm``), finite losses, and
    the WKV kernels' launches (rwkv6: a forward and a backward a layer,
    member and step; none for llama); for llama one leaf's coordinate
    multisets across a shuffle.  Then the trained soup is served (llama:
    ``ContinuousServer``; rwkv6: the scan engine), the same run made again
    unchecked for the step's split, tokens/s and peak memory, and one more
    step profiled.  Sets the launches of the kernel the phase owns in
    ``kernels`` (llama: the bucketed shuffle; rwkv6: the WKV backward)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import layer_index as tli
    from repro_torch.core.mixing import MixingConfig, static_mix_comm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as M
    from repro_torch.serving.engine import averaged_params

    cfg = get_arch(arch)
    rwkv = cfg.block_kind == "rwkv6"
    steps, seq, n = TRAIN_STEPS, TRAIN_SEQ, 2
    leaves, step_comm = TRAIN_PLANS[arch]
    argv = training_argv(arch, device)
    shapes = M.param_shapes(cfg)
    static = static_mix_comm(
        shapes, MixingConfig(kind="wash", base_p=0.01, mode="bucketed"),
        tli.infer_layer_ids(shapes, cfg.num_layers),
        tli.total_layers(cfg.num_layers), n)
    # llama: the stacked blocks.attn.wk is copied across its first shuffle
    # (width 0: no leaf is copied, only the applied plans' shapes kept)
    wk = 0 if rwkv else (cfg.num_layers * cfg.d_model * cfg.num_kv_heads
                         * cfg.resolved_head_dim)
    # rwkv6: a WKV forward and backward a layer, member and step; the CLI
    # then evaluates the averaged model's loss, a forward a layer
    expect = cfg.num_layers * n * steps if rwkv else 0
    expect_fwd = expect + cfg.num_layers if rwkv else 0
    seen, counts = {"plans": []}, {"dense": 0, "bucketed": 0}
    torch.cuda.synchronize()
    ws.bucketed_launches = ws.wash_launches = pa.launches = 0
    wkv.launches = wkv.backward_launches = 0
    t0 = time.perf_counter()
    with checked_shuffles(ops, ref, torch, counts), \
            watch_bucketed_shuffles(ops, wk, seen):
        res = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ws.bucketed_launches
    fwd, bwd = wkv.launches, wkv.backward_launches
    log(f"training ({cfg.name}, {cfg.num_layers} layers, {cfg.dtype}, "
        f"N={n}, SGD, bucketed WASH p=0.01, 2 x {seq} tokens per member, "
        f"{steps} steps) through launch.train.main, every shuffle held "
        f"against its plain version: {wall:.2f} s; bucketed shuffle "
        f"launches {launches} (expected {leaves} x {steps}), "
        f"{counts['bucketed']} of them bitwise equal to the plain version "
        f"on the same inputs, dense {ws.wash_launches}; WKV forward "
        f"launches {fwd} (expected {expect_fwd}"
        + (f": {cfg.num_layers} layers x {n} members x {steps} steps, + "
           f"{cfg.num_layers} for the averaged model's loss" if rwkv else "")
        + f"), backward calls {bwd} (expected {expect}); losses "
        f"{res.history['loss']}; comm {res.history['comm']}")
    if (launches != leaves * steps or ws.wash_launches
            or counts["bucketed"] != launches):
        fail(f"{arch} training: {launches} bucketed launches "
             f"({counts['bucketed']} checked) for {steps} steps of {leaves} "
             f"planned leaves ({ws.wash_launches} dense)")
    if (fwd, bwd) != (expect_fwd, expect):
        fail(f"{arch} training: {fwd} WKV forward launches and {bwd} "
             f"backward calls, expected {expect_fwd} and {expect}")
    applied, recorded = comm_per_step(seen, res.history, n, leaves)
    log(f"{arch} comm per step of the plans applied {applied}, recorded "
        f"{recorded} (expected {step_comm}, static_mix_comm {static})")
    if (applied != [step_comm] * steps or recorded != applied
            or static != step_comm):
        fail(f"{arch} training: comm per step {applied} applied, {recorded} "
             f"recorded, expected {step_comm}, static_mix_comm {static}")
    if not np.isfinite(res.history["loss"]).all():
        fail(f"{arch} training: losses {res.history['loss']} are not finite")
    if not rwkv:
        before, after = seen.get("before"), seen.get("after")
        if before is None:
            fail("training: no bucketed shuffle of blocks.attn.wk was seen")
        moved = int((before != after).any(dim=0).sum())
        same = torch.equal(torch.sort(before, dim=0).values,
                           torch.sort(after, dim=0).values)
        log(f"blocks.attn.wk across one shuffle: {moved} of "
            f"{before.shape[1]} columns changed; each column's multiset of "
            f"member values unchanged: {same}")
        if not same or moved == 0:
            fail("training: the shuffle did not preserve each coordinate's "
                 "multiset, or moved nothing")
        del before, after
    del seen
    if rwkv:
        kernels["wkv_bwd"]["launches"] = bwd
    else:
        kernels["bucketed"]["launches"] = launches

    soup = averaged_params(res)
    del res
    torch.cuda.empty_cache()
    serve_trained_soup(torch, device, cfg, soup)
    del soup
    torch.cuda.empty_cache()

    timed_training_run(torch, train_cli, argv, f"{arch} training")
    torch.cuda.empty_cache()
    profile_training_step(torch, device, cfg)
    pa.launches = wkv.launches = wkv.backward_launches = 0
    torch.cuda.empty_cache()


def serve_trained_soup(torch, device, cfg, soup):
    """llama: 4 requests through ``ContinuousServer``; rwkv6: 2 prompts of
    TRAIN_SEQ tokens and 8 new tokens through the scan engine (a WKV
    launch a layer for the prefill and each of the 7 decode steps, no
    backward)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch.serve import mixed_stream
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.serving import batching as B
    from repro_torch.serving import engine

    seq = TRAIN_SEQ
    if cfg.block_kind != "rwkv6":
        server = B.ContinuousServer(soup, cfg, mode="soup", page_size=16,
                                    max_slots=4, num_pages=128,
                                    max_pages_per_slot=-(-(seq + 16) // 16),
                                    device=device)
        serve_stream(torch, pa, server, mixed_stream(cfg, 4, seq, 16,
                                                     seed=12),
                     "trained soup stream (full width)", cfg.num_layers)
        return
    batch = concrete_batch(cfg, 21, 2, seq, device=device)
    wkv.launches = wkv.backward_launches = 0
    with torch.no_grad():
        toks = engine.generate(soup, cfg, batch, 8, device=device)
    torch.cuda.synchronize()
    log(f"trained rwkv6 soup through the scan engine (B=2, S={seq}, 8 new "
        f"tokens): WKV launches {wkv.launches} (expected "
        f"{cfg.num_layers * 8}), backward calls {wkv.backward_launches}")
    if (toks.shape != (2, seq + 8) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size
            or not torch.equal(toks[:, :seq], batch["tokens"].to(toks.dtype))):
        fail(f"trained rwkv6 soup: tokens of shape {tuple(toks.shape)}")
    if wkv.launches != cfg.num_layers * 8 or wkv.backward_launches:
        fail("trained rwkv6 soup: the scan engine's WKV launches are off")


def profile_training_step(torch, device, cfg):
    """One full-width training step (the third of three) under
    ``torch.profiler``: device time by operator and the device's busy
    share of the step's wall time (the step ends in a synchronizing
    read of the loss; the profiler's own host cost is in the wall time,
    so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core.mixing import MixingConfig

    marks = []
    mcfg = MixingConfig(kind="wash", base_p=0.01, mode="bucketed")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        def record(step, population):
            marks.append(time.perf_counter())
            prof.step()
            return {}

        _train(cfg, mcfg, "sgd", 3, device, seq=TRAIN_SEQ, record_fn=record)
    wall_ms = (marks[2] - marks[1]) * 1e3
    busy_ms, spans, full, top = device_activity(prof)
    log(f"profiled {cfg.name} training step (full width, N=2, 2 x "
        f"{TRAIN_SEQ} tokens a member, under torch.profiler): wall "
        f"{wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%, the union of "
        f"{spans} device activities), idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%; the host found the launch "
        f"queue full {full} times; device time by operator: {top}")
    if cfg.block_kind == "rwkv6":
        from repro_torch.kernels import rwkv6_scan as wkv
        log(f"profiled {cfg.name} training step: the WKV backward "
            f"{backward_profile(prof, wkv.BACKWARD_KERNELS)} (the earlier "
            f"two-pass kernel: _RWKV6ScanBackward 28.1 ms x 64)")


def backward_profile(prof, names) -> str:
    """From a finished ``torch.profiler`` run: the device time of the
    autograd ``_RWKV6ScanBackward`` operator (the WKV backward's calls) and
    of each backward kernel by name, totals over the run."""
    from torch.autograd import DeviceType

    op = [a for a in prof.key_averages()
          if a.device_type == DeviceType.CPU
          and a.key == "_RWKV6ScanBackward"]
    total = (f"_RWKV6ScanBackward {op[0].self_device_time_total / 1e3:.2f} "
             f"ms x{op[0].count}" if op else "_RWKV6ScanBackward not seen")
    return total + "; by kernel: " + ", ".join(
        f"{name} {us / 1e3:.2f} ms x{n}"
        for name, (us, n) in kernel_us(prof, names).items())


def device_activity(prof, n_top: int = 10):
    """From a finished ``torch.profiler`` run: the device's busy time (ms,
    the union of its activity intervals; the launch queue's "Command
    Buffer Full" markers are the host waiting, not device work), the
    number of activities, how often the host found the queue full, and
    the device time of the top operators."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full")
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    full = sum(e.name == "Command Buffer Full" for e in prof.events())
    ops = sorted((a for a in prof.key_averages()
                  if a.device_type == DeviceType.CPU
                  and a.key != "Command Buffer Full"
                  and a.self_device_time_total > 0),
                 key=lambda a: -a.self_device_time_total)
    top = "; ".join(f"{a.key} {a.self_device_time_total / 1e3:.1f} ms "
                    f"x{a.count}" for a in ops[:n_top])
    return busy_us / 1e3, len(spans), full, top


# ---------------------------------------------------------------------------
# phase 6: reduced paths, kernels against plain versions in training
# ---------------------------------------------------------------------------

REDUCED_LAYERS, REDUCED_STEPS = 4, 3   # phase 6: depth, steps


@contextlib.contextmanager
def plain_shuffles(ops, ref):
    """Route every shuffle through the plain versions for the block."""
    dense, bucketed = ops.wash_shuffle, ops.bucketed_shuffle_
    ops.wash_shuffle, ops.bucketed_shuffle_ = (ref.wash_shuffle_ref,
                                               ref.bucketed_shuffle_ref_)
    try:
        yield
    finally:
        ops.wash_shuffle, ops.bucketed_shuffle_ = dense, bucketed


def _train(cfg, mcfg, optimizer, steps, device, seq=64, record_fn=None):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.prng import fold_in
    from repro_torch.data import make_lm_task, sample_tokens
    from repro_torch.models import transformer as M
    from repro_torch.train.loop import train_population

    task = make_lm_task(fold_in(0, 1), vocab=min(cfg.vocab_size, 512),
                        device=device)

    def data_fn(m, step, s):
        return {"tokens": sample_tokens(task, s, 2, seq)}

    tcfg = TrainConfig(population=2, optimizer=optimizer, total_steps=steps,
                       lr=3e-4 if optimizer == "adamw" else 0.05, seed=0)
    return train_population(
        0, lambda s: M.init_params(cfg, seed=s, device=device),
        lambda p, b: M.loss_fn(p, cfg, b)[0], data_fn, tcfg, mcfg,
        cfg.num_layers, record_every=1 if record_fn else steps,
        record_fn=record_fn, device=device)


def reduced_paths(torch, device, kernels):
    """Phase 6: llama3.2-3b at full width cut to REDUCED_LAYERS layers,
    float32."""
    from repro_torch.configs import get_arch
    from repro_torch.core import population as pop
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as M
    from repro_torch.train import checkpoint

    base = get_arch("llama3.2-3b")
    steps = REDUCED_STEPS
    cfg = dataclasses.replace(base, num_layers=REDUCED_LAYERS, dtype="float32",
                              name=f"{base.name}-{REDUCED_LAYERS}layers-f32")
    runs = [("dense WASH, SGD", MixingConfig(kind="wash", base_p=0.01,
                                             mode="dense"), "sgd", "dense"),
            ("WASH+Opt, AdamW", MixingConfig(kind="wash_opt", base_p=0.01,
                                             mode="bucketed"), "adamw",
             "bucketed")]
    for what, mcfg, optimizer, kernel in runs:
        counts = {"dense": 0, "bucketed": 0}
        torch.cuda.synchronize()
        ws.wash_launches = ws.bucketed_launches = 0
        t0 = time.perf_counter()
        with checked_shuffles(ops, ref, torch, counts):
            res = _train(cfg, mcfg, optimizer, steps, device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"dense": ws.wash_launches, "bucketed": ws.bucketed_launches}
        moments = 2 if optimizer == "adamw" else 1
        per_step = TRAIN_PLANS[base.name][0] * (
            1 + moments if mcfg.kind == "wash_opt" else 1)
        expected = {"dense": 0, "bucketed": 0}
        expected[kernel] = per_step * steps
        kept = pop.tree_map(torch.clone, res.population)
        losses = res.history["loss"]
        del res
        with plain_shuffles(ops, ref):
            plain = _train(cfg, mcfg, optimizer, steps, device)
        diff = max(float((a - b).abs().max()) for a, b in zip(
            pop.tree_leaves(kept), pop.tree_leaves(plain.population)))
        log(f"{cfg.name}, {what}, {steps} steps: {dt:.2f} s; kernel launches "
            f"{launches} (expected {expected}); {counts[kernel]} shuffles "
            f"bitwise equal to their plain versions on the training inputs; "
            f"max |param kernel run - plain run| = {diff:.3e} (tolerance "
            f"{PARAM_TOL:g}); losses {losses} vs {plain.history['loss']}")
        if launches != expected or counts[kernel] != expected[kernel]:
            fail(f"{what}: launches {launches}, checks {counts}, expected "
                 f"{expected}")
        if diff > PARAM_TOL or not np.isfinite(losses).all():
            fail(f"{what}: kernel and plain runs differ by {diff}")
        if kernel == "dense":  # the dense kernel's path is this run
            kernels["dense"]["launches"] = launches["dense"]
        del kept, plain
        torch.cuda.empty_cache()

    # train CLI -> population file -> serve CLI, on the card
    out_dir = ROOT / "build" / "chip_smoke"
    ckpt = str(out_dir / "population.npz")
    res = train_cli.main(["--arch", "llama3.2-3b", "--reduced", "--population",
                          "2", "--mode", "bucketed", "--steps", "3",
                          "--batch-size", "2", "--seq-len", "32",
                          "--ckpt-population", ckpt, "--device", str(device)])
    like = pop.tree_map(lambda x: x.unsqueeze(0).expand((2,) + x.shape),
                        M.param_shapes(base.reduced()))
    back = checkpoint.restore(ckpt, like, device=device)
    if not all(torch.equal(a, b) for a, b in zip(
            pop.tree_leaves(back), pop.tree_leaves(res.population))):
        fail("population file does not restore bitwise")
    pa.launches = 0
    serve_cli.main(["--arch", "llama3.2-3b", "--reduced", "--continuous",
                    "--population", "2", "--ckpt", ckpt, "--requests", "4",
                    "--max-new", "8", "--seq-len", "32", "--device",
                    str(device)])
    torch.cuda.synchronize()
    log(f"train CLI --ckpt-population -> serve CLI --ckpt: restored bitwise, "
        f"served 4 requests with {pa.launches} paged-attention launches")
    if pa.launches == 0:
        fail("the served stream made no paged-attention launch")
    pa.launches = 0




# ---------------------------------------------------------------------------
# phase 7: the flash-attention and WKV kernels against their plain versions
# ---------------------------------------------------------------------------

FLASH_SHAPE = (4, 2048, 24, 8, 128)  # llama3.2-3b prefill: B, S, H, KV, hd
WKV_SHAPE = (4, 2048, 40, 64)        # rwkv6-3b prefill: B, T, H, hd
WKV_DECODE_LAYERS = 32  # rwkv6-3b: one WKV call a layer in a decode step

# tolerances, the tests/test_kernels.py bounds: flash 2e-5 in f32 (f32
# sums in another order), 2e-2 in bf16 (the tensor-core kernel rounds P to
# bf16 for P V, as every tensor-core flash does, and the output once);
# WKV (rtol, atol) 1e-4 in f32 (the f32 state summed in another order),
# 3e-2 / 3e-1 with bf16 inputs and outputs
FLASH_TOL = {"bf16": 2e-2, "f32": 2e-5}
WKV_TOL = {"f32": (1e-4, 1e-4), "bf16": (3e-2, 3e-1)}

_DTYPES = {"bf16": "bfloat16", "f32": "float32"}


def _gen(torch, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def flash_inputs(torch, B, S, H, KV, hd, dt, device, seed):
    gen = _gen(torch, device, seed)
    dtype = getattr(torch, _DTYPES[dt])
    return tuple(torch.randn(B, S, n, hd, generator=gen, device=device)
                 .to(dtype) for n in (H, KV, KV))


def flash_work(B, S, H, KV, hd, dt, causal, window=None):
    """Bytes (q, k, v read once, out written once) and operations (QK^T
    and PV, a multiply and an add each, over the visible pairs only)."""
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    visible = np.ones((S, S), bool)
    if causal:
        visible &= j <= i
    if window is not None:
        visible &= j > i - window
    elt = 2 if dt == "bf16" else 4
    nbytes = elt * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    ops = 4 * B * H * hd * int(visible.sum())
    return nbytes, ops


def bound(nbytes, ops, dt):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sass_count(library: Path, function_part: str, opcode: str) -> int:
    """Instructions whose text starts with ``opcode`` in the functions of
    a built library whose names hold ``function_part``, as ``cuobjdump
    -sass`` (beside ``nvcc``) disassembles them."""
    from repro_torch.kernels import build as kbuild

    tool = Path(kbuild.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump: {out.stderr.strip()}")
    count, inside = 0, False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = function_part in line
        elif inside and f" {opcode}" in line:
            count += 1
    return count


def check_flash(torch, fa, ref, F, device):
    """Phase 7, flash attention.  Returns the entries of the JSON line for
    the two variants the scan engine runs (bf16 at full width, f32 at the
    reduced size), launches filled in by phase 8."""
    B, S, H, KV, hd = FLASH_SHAPE
    cases = [("bf16", S, True, None), ("f32", S, True, None),
             ("bf16", S, True, 512), ("bf16", 1000, False, None),
             ("f32", 1000, False, None)]
    errs = {}
    for n, (dt, s, causal, window) in enumerate(cases):
        q, k, v = flash_inputs(torch, B, s, H, KV, hd, dt, device, 70 + n)
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail(f"flash {dt} S={s}: kernel output is not finite")
        err = float((got.float() - want.float()).abs().max())
        what = (f"flash attention {dt} B={B} S={s} H={H} KV={KV} hd={hd} "
                f"{'causal' if causal else 'non-causal'}"
                f"{f' window {window}' if window else ''}")
        log(f"{what}: max |kernel - plain| = {err:.3e} (tolerance "
            f"{FLASH_TOL[dt]:g})")
        if err > FLASH_TOL[dt]:
            fail(f"{what} disagrees with its plain version: {err}")
        if s == S and causal and window is None:
            errs[dt] = err
        del q, k, v, got, want
    torch.cuda.empty_cache()

    entries = {}
    for dt in ("bf16", "f32"):
        # two input sets, cycled, so K/V do not stay in L2 between calls
        sets = [flash_inputs(torch, B, S, H, KV, hd, dt, device, 80 + i)
                for i in range(2)]
        lib = [tuple(x.transpose(1, 2).contiguous() for x in xs)
               for xs in sets]
        n0 = fa.launches
        ms = device_ms(torch, lambda i: fa.flash_attention_cuda(*sets[i]), 2)
        plain_ms = device_ms(torch,
                             lambda i: ref.flash_attention_ref(*sets[i]), 2,
                             reps=5)
        library_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
            *lib[i], is_causal=True, enable_gqa=True), 2)
        ms2 = device_ms(torch, lambda i: fa.flash_attention_cuda(*sets[i]), 2)
        fa.launches = n0  # comparison launches do not count
        nbytes, ops = flash_work(B, S, H, KV, hd, dt, True)
        bound_ms, bound_by = bound(nbytes, ops, dt)
        design = ("wgmma on the tensor cores, TMA-fed" if dt == "bf16"
                  else "3xTF32 mma.sync on the tensor cores, cp.async-fed")
        rate = ops / (ms * 1e-3)
        against = (f"{rate / PEAK_OPS['bf16']:.1%} of the bf16 rate"
                   if dt == "bf16" else
                   f"{rate / PEAK_OPS['f32']:.1%} of the 3xTF32 rate "
                   f"({PEAK_OPS['f32'] / 1e12:.1f} TFLOP/s), "
                   f"{rate / FFMA_OPS:.1%} of the FFMA rate "
                   f"({FFMA_OPS / 1e12:.0f} TFLOP/s)")
        log(f"flash attention {dt} causal at the llama3.2-3b prefill shape "
            f"({design}): {ms:.4f} ms on the device (again {ms2:.4f}), plain "
            f"{plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {ops} ops); "
            f"achieved {rate / 1e12:.2f} TFLOP/s, {against}; "
            f"{attributes_line(fa.kernel_attributes(sets[0][0].dtype, hd))}")
        entries[f"flash_{dt}"] = {
            "name": f"flash_attention[{dt},causal]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:77",
            "launches": 0,
            "max_abs_err": errs[dt],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        }
        del sets, lib
        torch.cuda.empty_cache()
    from repro_torch.kernels import build as kbuild

    hmma = sass_count(kbuild.library_path(fa.SOURCE), "flash_f32_kernel",
                      "HMMA.1688.F32.TF32")
    log(f"flash attention f32 in the library's SASS: {hmma} TF32 tensor-core "
        f"instructions (HMMA.1688.F32.TF32) over its three head dims")
    if hmma == 0:
        fail("the f32 flash kernel issues no TF32 mma")
    return entries


def wkv_inputs(torch, B, T, H, hd, dt, device, seed, extreme=False):
    """Drawn as tests/test_kernels.py draws them: normal r/k/v,
    w = sigmoid(normal), u = 0.1 normal; plus a normal initial state.
    ``extreme``: w = exp(-exp(x)), x uniform over [-8, 6] (from ~0.9997
    down to an underflow to 0), every 7th value exactly 0 and every 11th
    1 - 2**-24."""
    gen = _gen(torch, device, seed)
    dtype = getattr(torch, _DTYPES[dt])
    r, k, v = (torch.randn(B, T, H, hd, generator=gen, device=device)
               .to(dtype) for _ in range(3))
    x = torch.randn(B, T, H, hd, generator=gen, device=device)
    if extreme:
        x = torch.rand(B, T, H, hd, generator=gen, device=device) * 14 - 8
        w = torch.exp(-torch.exp(x))
        w.view(-1)[::7] = 0.0
        w.view(-1)[3::11] = 1.0 - 2.0 ** -24
    else:
        w = torch.sigmoid(x)
    u = 0.1 * torch.randn(H, hd, generator=gen, device=device)
    s0 = torch.randn(B, H, hd, hd, generator=gen, device=device)
    return r, k, v, w.to(dtype), u, s0


def wkv_work(B, T, H, hd):
    """Bytes (r, k, v, w, u and the state read once, y and the state
    written once, f32) and operations (5 per state element and step: the
    r S multiply-add for y, k v and the w S + kv multiply-add; the bonus
    factors as v_j * sum_i r_i u_i k_i, O(hd) per step)."""
    nbytes = 4 * (5 * B * T * H * hd + H * hd + 2 * B * H * hd * hd)
    return nbytes, 5 * B * T * H * hd * hd


def check_wkv(torch, wkv, ref, device):
    """Phase 7, WKV.  Returns its entry of the JSON line (launches filled
    in by phase 8).  The time mix feeds the kernel float32 r/k/v/w and a
    carried state at every width, so that is the variant timed."""
    B, T, H, hd = WKV_SHAPE
    # (dtype, steps, carried state, extreme decays)
    cases = [("f32", T, False, False), ("f32", T, True, False),
             ("f32", 1, True, False), ("bf16", T, False, False),
             ("f32", T, True, True), ("bf16", 1, True, False)]
    err_main = 0.0
    for n, (dt, t, with_state, extreme) in enumerate(cases):
        r, k, v, w, u, s0 = wkv_inputs(torch, B, t, H, hd, dt, device, 90 + n,
                                       extreme)
        state = s0 if with_state else None
        got = wkv.rwkv6_scan_cuda(r, k, v, w, u, state=state)
        want = ref.rwkv6_scan_ref(r, k, v, w, u, state=state)
        torch.cuda.synchronize()
        if not with_state:
            got, want = (got, None), (want, None)
        rtol, atol = WKV_TOL[dt]
        what = (f"rwkv6 scan {dt} B={B} T={t} H={H} hd={hd} "
                f"{'from a carried state' if with_state else 'from zero'}"
                f"{', extreme decays' if extreme else ''}")
        for name, g, wa in (("y", got[0], want[0]),
                            ("final state", got[1], want[1])):
            if g is None:
                continue
            g, wa = g.float(), wa.float()
            if not (torch.isfinite(g).all() and torch.isfinite(wa).all()):
                fail(f"{what}: {name} is not finite")
            err = float((g - wa).abs().max())
            excess = float(((g - wa).abs() - rtol * wa.abs()).max())
            log(f"{what}: {name} max |kernel - plain| = {err:.3e} (max "
                f"|plain| {float(wa.abs().max()):.3e}; tolerance rtol "
                f"{rtol:g} atol {atol:g})")
            if excess > atol:
                fail(f"{what}: {name} disagrees with its plain version")
            if dt == "f32" and t == T and with_state:
                err_main = max(err_main, err)
        del r, k, v, w, u, s0, got, want
    torch.cuda.empty_cache()

    sets = [wkv_inputs(torch, B, T, H, hd, "f32", device, 95 + i)
            for i in range(2)]
    n0 = wkv.launches
    ms = wkv_ms(torch, wkv.rwkv6_scan_cuda, sets)
    plain_ms = wkv_ms(torch, ref.rwkv6_scan_ref, sets, reps=3)
    ms2 = wkv_ms(torch, wkv.rwkv6_scan_cuda, sets)
    # the decode shape (T = 1), where most of the path's launches are: two
    # input sets cycled (decode_ms), and a decode step's 32 layers' calls,
    # a state each, so the states are read cold (decode_step_ms)
    dec = [wkv_inputs(torch, B, 1, H, hd, "f32", device, 97 + i)
           for i in range(2)]
    dec_ms = wkv_ms(torch, wkv.rwkv6_scan_cuda, dec)
    dec_plain_ms = wkv_ms(torch, ref.rwkv6_scan_ref, dec)
    dec_layers = [wkv_inputs(torch, B, 1, H, hd, "f32", device, 97 + i)
                  for i in range(WKV_DECODE_LAYERS)]
    dec_step_ms = wkv_ms(torch, wkv.rwkv6_scan_cuda, dec_layers)
    wkv.launches = n0
    nbytes, ops = wkv_work(B, T, H, hd)
    bound_ms, bound_by = bound(nbytes, ops, "f32")
    log(f"rwkv6 scan f32 with a carried state at the rwkv6-3b prefill shape: "
        f"{ms:.4f} ms on the device (again {ms2:.4f}), plain {plain_ms:.4f} "
        f"ms, library none, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} "
        f"B, {ops} ops); achieved {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s; "
        f"{attributes_line(wkv.kernel_attributes(torch.float32, hd, T))}")
    dec_bytes, dec_ops = wkv_work(B, 1, H, hd)
    dec_bound, dec_by = bound(dec_bytes, dec_ops, "f32")
    log(f"rwkv6 scan f32 with a carried state at the decode shape (B={B}, "
        f"T=1): {dec_ms:.4f} ms on the device (two input sets cycled), "
        f"plain {dec_plain_ms:.4f} ms, {dec_step_ms:.4f} ms a call over "
        f"{WKV_DECODE_LAYERS} layers' calls, a state each; bound "
        f"{dec_bound:.4f} ms by {dec_by} ({dec_bytes} B, {dec_ops} ops); "
        f"achieved {dec_bytes / (dec_ms * 1e-3) / 1e9:.1f} GB/s; "
        f"{attributes_line(wkv.kernel_attributes(torch.float32, hd, 1))}")
    del sets, dec, dec_layers
    torch.cuda.empty_cache()
    return {"wkv": {
        "name": "rwkv6_scan[f32,state]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:48",
        "launches": 0,
        "max_abs_err": err_main,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "decode_ms": dec_ms,
        "decode_plain_ms": dec_plain_ms,
        "decode_step_ms": dec_step_ms,
        "decode_bound_ms": dec_bound,
    }}


WKV_TRAIN_SHAPE = (2, 256, 40, 64)  # rwkv6-3b training: B, T, H, hd
# the backward against its plain version: max |kernel - plain| / max |plain|
# per grad (both sum the f32 state's products in another order)
WKV_BWD_TOL = 1e-4


def wkv_bwd_inputs(torch, B, T, H, hd, device, seed, extreme=False):
    """``wkv_inputs`` in f32 plus the upstream grads: dy (B, T, H, hd) and
    the final state's grad (B, H, hd, hd), both normal."""
    xs = wkv_inputs(torch, B, T, H, hd, "f32", device, seed, extreme)
    gen = _gen(torch, device, seed + 1000)
    dy = torch.randn(B, T, H, hd, generator=gen, device=device)
    ds = torch.randn(B, H, hd, hd, generator=gen, device=device)
    return xs + (dy, ds)


def wkv_bwd_work(B, T, H, hd, carried: bool):
    """What the function must move and compute.  Bytes: r, k, v, w, dy
    read and dr, dk, dv, dw written once, u and du, with a carried state
    the state and the final state's grad read and dstate0 written; all
    f32 (the kernel's workspace is its design's cost, not the
    function's).  Operations: 14 a state element and
    step (the state w S + k v and its adjoint w G + r dy, 3 each; the
    four sums G v, k G, G S and S dy, 2 each)."""
    nbytes = 4 * (9 * B * T * H * hd + 2 * H * hd
                  + (3 * B * H * hd * hd if carried else 0))
    return nbytes, 14 * B * T * H * hd * hd


def check_wkv_backward(torch, wkv, ref, device):
    """Phase 7, the WKV backward (training): every grad against
    ``rwkv6_scan_bwd_ref`` at rwkv6-3b's training shape from zero, at the
    prefill shape from a carried state with a final-state grad, with
    extreme decays, at a ragged T and at hd 32; then timed at both shapes.
    Returns its entry of the JSON line (launches filled in by phase 9)."""
    B, T, H, hd = WKV_TRAIN_SHAPE
    PB, PT = WKV_SHAPE[:2]
    # (what, shape, carried state and final-state grad, extreme decays)
    cases = [("training shape, from zero", (B, T, H, hd), False, False),
             ("prefill shape, carried state and final-state grad",
              (PB, PT, H, hd), True, False),
             ("extreme decays", (B, T, H, hd), True, True),
             ("ragged T=1000", (B, 1000, H, hd), True, False),
             ("hd 32", (B, T, 80, 32), True, False)]
    err_main = 0.0
    for n, (what, shape, carried, extreme) in enumerate(cases):
        r, k, v, w, u, s0, dy, ds = wkv_bwd_inputs(torch, *shape, device,
                                                   110 + n, extreme)
        state, dfinal = (s0, ds) if carried else (None, None)
        got = wkv.rwkv6_scan_bwd_cuda(r, k, v, w, u, state, dy, dfinal)
        torch.cuda.synchronize()
        want = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy, dfinal)
        errs = {}
        for name, g, wa in zip(("dr", "dk", "dv", "dw", "du", "dstate0"),
                               got, want):
            if not carried and name == "dstate0":
                continue
            if not (torch.isfinite(g).all() and torch.isfinite(wa).all()):
                fail(f"rwkv6 scan backward {what}: {name} is not finite")
            errs[name] = float((g - wa).abs().max() / wa.abs().max())
        log(f"rwkv6 scan backward {what} (B, T, H, hd = {shape}): max "
            f"|kernel - plain| / max |plain| "
            + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
            + f" (tolerance {WKV_BWD_TOL:g}); every value finite")
        if max(errs.values()) > WKV_BWD_TOL:
            fail(f"rwkv6 scan backward {what} disagrees with its plain "
                 f"version: {errs}")
        if n == 0:
            err_main = max(float((g - wa).abs().max())
                           for g, wa in zip(got[:5], want[:5]))
            # and the plain model of the kernel's own arithmetic (the
            # chunk walks and the per-chunk forms)
            model = ref.rwkv6_scan_bwd_chunked_ref(r, k, v, w, u, state, dy,
                                                   dfinal)
            merrs = {name: float((g - m).abs().max() / m.abs().max())
                     for name, g, m in zip(("dr", "dk", "dv", "dw", "du"),
                                           got, model)}
            log(f"rwkv6 scan backward {what}: max |kernel - chunked plain "
                f"model| / max |model| "
                + ", ".join(f"{k_} {e:.3e}" for k_, e in merrs.items())
                + f" (tolerance {WKV_BWD_TOL:g})")
            if max(merrs.values()) > WKV_BWD_TOL:
                fail(f"rwkv6 scan backward {what} disagrees with the plain "
                     f"model of its arithmetic: {merrs}")
            del model
        del r, k, v, w, u, s0, dy, ds, got, want
    torch.cuda.empty_cache()

    times = {}
    for key, (b, t, carried) in (("train", (B, T, False)),
                                 ("prefill", (PB, PT, True))):
        sets = [wkv_bwd_inputs(torch, b, t, H, hd, device, 120 + i)
                for i in range(2)]

        def args(i):
            r, k, v, w, u, s0, dy, ds = sets[i]
            return (r, k, v, w, u, s0 if carried else None, dy,
                    ds if carried else None)

        n0 = wkv.backward_launches
        ms = device_ms(torch, lambda i: wkv.rwkv6_scan_bwd_cuda(*args(i)), 2)
        plain_ms = device_ms(torch, lambda i: ref.rwkv6_scan_bwd_ref(
            *args(i)), 1, reps=1 if key == "prefill" else 3)
        ms2 = device_ms(torch, lambda i: wkv.rwkv6_scan_bwd_cuda(*args(i)), 2)
        each = launch_ms(torch, lambda i: wkv.rwkv6_scan_bwd_cuda(*args(i)),
                         2, wkv.BACKWARD_KERNELS)
        wkv.backward_launches = n0  # comparison launches do not count
        nbytes, ops = wkv_bwd_work(b, t, H, hd, carried)
        bound_ms, bound_by = bound(nbytes, ops, "f32")
        # the design's own traffic, beside the function's: S_in and G_out
        # of every chunk (f32) written and read once, and the walks' reads
        # of k, w, v (forward) and r, w, dy (reverse) again
        ws_bytes = 2 * 2 * 4 * b * H * -(-t // ref.WKV_BWD_CHUNK) * hd * hd
        walk_bytes = 6 * 4 * b * t * H * hd
        times[key] = (ms, plain_ms, bound_ms, bound_by)
        log(f"rwkv6 scan backward f32 at the {key} shape (B={b}, T={t}, "
            f"H={H}, hd={hd}{', carried state' if carried else ', from zero'}"
            f"): {ms:.4f} ms on the device (again {ms2:.4f}; two input sets "
            f"cycled, a call's three launches), plain {plain_ms:.4f} ms, "
            f"library none, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} "
            f"B the function moves: {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
            f"{ops} ops at the f32 peak: "
            f"{ops / PEAK_OPS['f32'] * 1e3:.4f} ms); the chunks' S_in and "
            f"G_out add {ws_bytes} B written and read "
            f"({ws_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate; "
            f"{wkv.backward_workspace_bytes(b, t, H, hd)} B of workspace "
            f"allocated in all), the walks' second reads of the inputs "
            f"{walk_bytes} B ({walk_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms): "
            f"the design's floor "
            f"{(nbytes + ws_bytes + walk_bytes) / HBM_BYTES_PER_S * 1e3:.4f} "
            f"ms; achieved {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of the "
            f"function's bytes, {ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; "
            f"each launch (device time under torch.profiler, mean of "
            f"{LAUNCH_CALLS} calls): "
            + ", ".join(f"{name} {v:.4f} ms" for name, v in each.items()))
        del sets
        torch.cuda.empty_cache()
    for d in wkv.BACKWARD_HEAD_DIMS:
        for name, attrs in wkv.backward_attributes(d).items():
            log(f"rwkv6 scan backward {name} at hd {d}: "
                f"{attributes_line(attrs)}")
    ms, plain_ms, bound_ms, bound_by = times["train"]
    return {"wkv_bwd": {
        "name": "rwkv6_scan_bwd[f32,training shape]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/models/ssm.py:211",
        "launches": 0,
        "max_abs_err": err_main,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "prefill_ms": times["prefill"][0],
        "prefill_plain_ms": times["prefill"][1],
    }}


LAUNCH_CALLS = 10  # calls profiled for each launch's device time


def kernel_us(prof, names):
    """From a finished ``torch.profiler`` run: for each of ``names``, the
    device time (us) and count of the kernels whose names hold it."""
    from torch.autograd import DeviceType

    found = {name: [0.0, 0] for name in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.name:
                    found[name][0] += e.time_range.end - e.time_range.start
                    found[name][1] += 1
    return found


def launch_ms(torch, fn, n_sets, names):
    """Device time of each kernel whose name holds one of ``names`` in a
    ``fn(i)`` call, ms: ``LAUNCH_CALLS`` calls (input sets cycled) under
    ``torch.profiler``, mean per call."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in range(LAUNCH_CALLS):
            fn(c % n_sets)
        torch.cuda.synchronize()
    found = kernel_us(prof, names)
    if not all(n for _, n in found.values()):
        fail(f"the profiler saw no launch of some of {names}: {found}")
    return {name: us / LAUNCH_CALLS / 1e3 for name, (us, _) in found.items()}


def wkv_ms(torch, fn, sets, reps=20):
    """Device time of one ``fn`` call (f32, carried state), one call an
    input set in the graph."""
    return device_ms(torch, lambda i: fn(*sets[i][:5], state=sets[i][5]),
                     len(sets), reps=reps)


# ---------------------------------------------------------------------------
# phase 8: the scan engine at full width, then reduced against plain
# ---------------------------------------------------------------------------

SCAN_B, SCAN_S, SCAN_NEW = 4, 2048, 32  # the request shape of phase 8
MODE_MEMBERS = {"soup": 1, "member": 1, "ensemble": 2}  # with N = 2
REQUESTS_PER_MODE = 2  # the serve CLI's first request and its timed one

def _counts(fa, wkv, pa):
    return {"flash": fa.launches, "wkv": wkv.launches, "paged": pa.launches}


def _zero(fa, wkv, pa):
    fa.launches = wkv.launches = pa.launches = 0


def serve_full_width(torch, device, arch, card):
    """The serve CLI without --continuous, --compare: each mode served
    twice (its first request and the timed one) from a random N = 2
    population.  Returns the launches of the run, checked exactly."""
    from repro_torch.configs import get_arch
    from repro_torch.core.prng import fold_in
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.specs import concrete_batch

    cfg = get_arch(arch)
    members = sum(MODE_MEMBERS.values())
    if cfg.block_kind == "rwkv6":  # every time mix, prefill and decode
        expect = {"flash": 0, "paged": 0, "wkv": REQUESTS_PER_MODE
                  * cfg.num_layers * members * (1 + SCAN_NEW - 1)}
    else:  # every prefill attention; decode attends with plain sdpa
        expect = {"flash": REQUESTS_PER_MODE * cfg.num_layers * members,
                  "paged": 0, "wkv": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(fa, wkv, pa)
    t0 = time.perf_counter()
    outs = serve_cli.main(["--arch", arch, "--population", "2", "--seed", "0",
                           "--batch-size", str(SCAN_B), "--seq-len",
                           str(SCAN_S), "--max-new", str(SCAN_NEW),
                           "--compare"])
    torch.cuda.synchronize()
    counts = _counts(fa, wkv, pa)
    dt = time.perf_counter() - t0
    log(f"scan engine {arch} (full width, {cfg.num_layers} layers, "
        f"{cfg.dtype}, N=2, B={SCAN_B}, S={SCAN_S}, max_new {SCAN_NEW}, "
        f"every mode twice): {dt:.2f} s with the population's init; kernel "
        f"launches {counts} (expected {expect}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != expect:
        fail(f"{arch}: kernel launches {counts}, expected {expect}")
    prompts = concrete_batch(cfg, fold_in(0, 2), SCAN_B, SCAN_S,
                             device=device)["tokens"]
    for mode, res in outs.items():
        toks = res["tokens"]
        if toks.shape != (SCAN_B, SCAN_S + SCAN_NEW):
            fail(f"{arch} {mode}: tokens of shape {tuple(toks.shape)}")
        if not torch.equal(toks[:, :SCAN_S].long(), prompts.long()):
            fail(f"{arch} {mode}: the prompt was not kept")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            fail(f"{arch} {mode}: sampled out of the vocabulary")
        log(f"scan engine {arch} {mode}: {res['tok_s']:.2f} tok/s (B="
            f"{SCAN_B} x {SCAN_NEW} new tokens in {res['steady_s']:.3f} s, "
            f"prefill of {SCAN_S} tokens included; first request "
            f"{res['first_s']:.2f} s) on {card}")
    return counts


def _forced_layers(torch, M, ops, ref, route, params, cfg, x, caches, pos,
                   worst):
    """Every layer once on the kernel route and once on the plain route,
    both on the same input (the plain route's output of the layer before)
    and each into its own cache; records each layer's max |kernel - plain|
    over max |plain| in ``worst``.  Returns the last layer's two outputs."""
    cache_k, cache_p = caches
    for l in range(cfg.num_layers):
        blk = M._block(params, l)
        xk, new_k = M._block_serve(blk, cfg, x, M._cache_layer(cache_k, l),
                                   pos)
        M._store_layer(cache_k, l, new_k)
        with plain_routes(ops, ref, route):
            xp, new_p = M._block_serve(blk, cfg, x,
                                       M._cache_layer(cache_p, l), pos)
        M._store_layer(cache_p, l, new_p)
        pairs = [("layer output", xk, xp)]
        if "state" in new_k:
            pairs += [(f"state {leaf}", new_k["state"][leaf],
                       new_p["state"][leaf]) for leaf in ("S", "x_tm", "x_cm")]
        for name, a, b in pairs:
            rel = float((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp(min=1e-30))
            worst[name] = max(worst.get(name, 0.0), rel)
        x = xp
    return xk, xp


def profile_serving(torch, params, cfg, tokens, cap, arch):
    """One full-width prefill and one decode step on the kernel path, each
    under ``torch.profiler``: the device's busy share of the wall time
    (the profiler's own host cost is in the wall time, so the idle share
    is an upper bound) and device time by operator."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as M

    cache = {}

    def prefill():
        _, cache["c"] = M.prefill(params, cfg, {"tokens": tokens},
                                  capacity=cap)

    def step():
        M.decode_step(params, cfg, tokens[:, -1:], cache["c"], SCAN_S)

    for what, fn in (("prefill", prefill), ("decode step", step)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, spans, full, top = device_activity(prof, n_top=6)
        log(f"profiled {arch} {what} (full width, B={SCAN_B}, kernel path, "
            f"under torch.profiler): wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%, {spans} "
            f"device activities), idle {100 * (1 - busy_ms / wall_ms):.1f}%; "
            f"launch queue full {full} times; device time by operator: {top}")


def teacher_forced(torch, device, arch):
    """Phase 8's kernel path against its plain path on member 0 (the CLI's
    seed), at the phase's request shape: a prefill and one decode step.

    Teacher-forced, layer by layer (the gate): every layer gets the same
    input on both paths (the plain path's output of the layer before; for
    the decode step, the plain path's cache too), and its output, rwkv6's
    new state, and the logits of the last layer's two outputs must agree
    within bf16 tolerance (``LOGIT_REL_TOL`` x the plain side's max).
    Before it, one timed prefill and decode step on the kernel path alone,
    which must launch the path's kernel once a layer each."""
    from repro_torch.configs import get_arch
    from repro_torch.core import population as pop
    from repro_torch.core.prng import fold_in
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import transformer as M

    cfg = get_arch(arch)
    route = "rwkv6_scan" if cfg.block_kind == "rwkv6" else "flash_attention"
    key = "wkv" if route == "rwkv6_scan" else "flash"
    params = M.init_params(cfg, seed=0, device=device)
    tokens = concrete_batch(cfg, fold_in(0, 2), SCAN_B, SCAN_S,
                            device=device)["tokens"]
    cap = SCAN_S + SCAN_NEW

    def drift(a, b):
        return max(float((x.float() - y.float()).abs().max()
                         / y.float().abs().max()) for x, y in zip(a, b))

    with torch.no_grad():
        _zero(fa, wkv, pa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = M.prefill(params, cfg, {"tokens": tokens}, capacity=cap)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        M.decode_step(params, cfg, lg[:, -1].argmax(-1)[:, None], cache,
                      SCAN_S)
        torch.cuda.synchronize()
        t_pre, t_dec = t1 - t0, time.perf_counter() - t1
        counts = _counts(fa, wkv, pa)
        del lg, cache
        expect = cfg.num_layers * (2 if route == "rwkv6_scan" else 1)
        log(f"{arch} (full width, member 0, B={SCAN_B}): prefill of {SCAN_S} "
            f"tokens {t_pre:.3f} s, one decode step {t_dec * 1e3:.1f} ms on the "
            f"kernel path (eager, host included; {counts[key]} {key} "
            f"launches, expected {expect})")
        if counts[key] != expect:
            fail(f"{arch}: {counts[key]} launches for a prefill and a step")
        profile_serving(torch, params, cfg, tokens, cap, arch)

        worst = {}
        caches = (M.init_cache(cfg, SCAN_B, cap, device=device),
                  M.init_cache(cfg, SCAN_B, cap, device=device))
        x = M._embed_tokens(params, cfg, tokens)
        xk, xp = _forced_layers(torch, M, ops, ref, route, params, cfg, x,
                                caches, None, worst)
        lg_k = M._logits(params, cfg, xk[:, -1:])
        lg_p = M._logits(params, cfg, xp[:, -1:])
        nxt = lg_p[:, -1].argmax(-1)
        for a, b in zip(pop.tree_leaves(caches[0]),
                        pop.tree_leaves(caches[1])):
            a.copy_(b)  # the decode step starts from the plain cache
        x = M._embed_tokens(params, cfg, nxt[:, None], pos0=SCAN_S)
        xk2, xp2 = _forced_layers(torch, M, ops, ref, route, params, cfg, x,
                                  caches, SCAN_S, worst)
        worst["prefill logits"] = drift([lg_k], [lg_p])
        worst["decode-step logits"] = drift(
            [M._logits(params, cfg, xk2)], [M._logits(params, cfg, xp2)])
    log(f"teacher-forced {arch}, layer by layer ({cfg.num_layers} layers, "
        f"prefill and decode step): worst max |kernel - plain| / max |plain| "
        + ", ".join(f"{name} {v:.4e}" for name, v in worst.items())
        + f" (tolerance {LOGIT_REL_TOL:g})")
    bad = {name: v for name, v in worst.items() if not v <= LOGIT_REL_TOL}
    if bad:
        fail(f"teacher-forced {arch}: kernel path differs from plain: {bad}")
    _zero(fa, wkv, pa)
    del params, caches
    torch.cuda.empty_cache()


def scan_reduced_f32(torch, device):
    """The reduced float32 rwkv6 and llama through ``engine.generate`` on
    the kernel path and on the plain path: greedy tokens identical.
    Returns the launches of the kernel runs."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch.serve import init_population
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.serving import engine
    from repro_torch.serving.engine import averaged_params

    launches = {}
    for arch in ("rwkv6-3b", "llama3.2-3b"):
        cfg = get_arch(arch).reduced()
        popn = init_population(cfg, 2, seed=3, device=device)
        batch = concrete_batch(cfg, 7, 4, 64, device=device)
        route = "rwkv6_scan" if cfg.block_kind == "rwkv6" else "flash_attention"
        for mode in ("soup", "ensemble"):
            params = engine.serving_params(popn, mode)
            torch.cuda.synchronize()
            _zero(fa, wkv, pa)
            out_k = engine.generate(params, cfg, batch, 16, mode=mode,
                                    device=device)
            torch.cuda.synchronize()
            counts = _counts(fa, wkv, pa)
            with plain_routes(ops, ref, route):
                out_p = engine.generate(params, cfg, batch, 16, mode=mode,
                                        device=device)
            same = torch.equal(out_k, out_p)
            members = MODE_MEMBERS[mode]
            expect = cfg.num_layers * members * (16 if route == "rwkv6_scan"
                                                 else 1)
            key = "wkv" if route == "rwkv6_scan" else "flash"
            log(f"reduced f32 {arch} {mode} (B=4, S=64, 16 new): greedy "
                f"tokens kernel path == plain path: {same}; {key} launches "
                f"{counts[key]} (expected {expect})")
            if not same:
                fail(f"reduced f32 {arch} {mode}: greedy tokens differ")
            if counts[key] != expect:
                fail(f"reduced f32 {arch} {mode}: {counts[key]} launches")
            launches[key] = launches.get(key, 0) + counts[key]
        if route == "rwkv6_scan":
            hd16 = dataclasses.replace(cfg, rwkv_head_dim=16)
            refused("engine.generate of rwkv6 at rwkv_head_dim=16",
                    lambda: engine.generate(params, hd16, batch, 16,
                                            device=device),
                    str(wkv.HEAD_DIMS))
        del popn
    return launches


def scan_engine(torch, device, kernels, card):
    """Phase 8."""
    counts = serve_full_width(torch, device, "rwkv6-3b", card)
    kernels["wkv"]["launches"] = counts["wkv"]
    teacher_forced(torch, device, "rwkv6-3b")
    counts = serve_full_width(torch, device, "llama3.2-3b", card)
    kernels["flash_bf16"]["launches"] = counts["flash"]
    teacher_forced(torch, device, "llama3.2-3b")
    reduced = scan_reduced_f32(torch, device)
    kernels["flash_f32"]["launches"] = reduced["flash"]


# ---------------------------------------------------------------------------
# phase 9 (after train_full_width on rwkv6-3b): reduced f32 rwkv6 training
# on the kernels against plain
# ---------------------------------------------------------------------------


def train_rwkv6_reduced(torch, device):
    """The reduced float32 rwkv6 (2 layers, d_model 256, hd 32) trained 3
    steps on the kernels and on the plain versions: the final params
    within PARAM_TOL; then the train CLI's ``--ckpt-population`` into the
    serve CLI's ``--ckpt`` (the scan engine) on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.core import population as pop
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as M
    from repro_torch.train import checkpoint

    cfg = get_arch("rwkv6-3b").reduced()
    steps = REDUCED_STEPS
    mcfg = MixingConfig(kind="wash", base_p=0.01, mode="bucketed")
    torch.cuda.synchronize()
    wkv.launches = wkv.backward_launches = 0
    res = _train(cfg, mcfg, "sgd", steps, device)
    torch.cuda.synchronize()
    fwd, bwd = wkv.launches, wkv.backward_launches
    kept = pop.tree_map(torch.clone, res.population)
    losses = res.history["loss"]
    del res
    with plain_routes(ops, ref, "rwkv6_scan"), plain_shuffles(ops, ref):
        plain = _train(cfg, mcfg, "sgd", steps, device)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        pop.tree_leaves(kept), pop.tree_leaves(plain.population)))
    expect = cfg.num_layers * 2 * steps
    log(f"{cfg.name}, bucketed WASH, SGD, {steps} steps: WKV forward "
        f"launches {fwd}, backward calls {bwd} (expected {expect} each); max "
        f"|param kernel run - plain run| = {diff:.3e} (tolerance "
        f"{PARAM_TOL:g}); losses {losses} vs {plain.history['loss']}")
    if (fwd, bwd) != (expect, expect):
        fail(f"reduced rwkv6 training: {fwd} forward / {bwd} backward "
             f"launches, expected {expect}")
    if diff > PARAM_TOL or not np.isfinite(losses).all():
        fail(f"reduced rwkv6 training: kernel and plain runs differ by {diff}")
    del kept, plain

    ckpt = str(ROOT / "build" / "chip_smoke" / "rwkv6_population.npz")
    res = train_cli.main(["--arch", "rwkv6-3b", "--reduced", "--population",
                          "2", "--mode", "bucketed", "--steps", "3",
                          "--batch-size", "2", "--seq-len", "32",
                          "--ckpt-population", ckpt, "--device", str(device)])
    like = pop.tree_map(lambda x: x.unsqueeze(0).expand((2,) + x.shape),
                        M.param_shapes(cfg))
    back = checkpoint.restore(ckpt, like, device=device)
    if not all(torch.equal(a, b) for a, b in zip(
            pop.tree_leaves(back), pop.tree_leaves(res.population))):
        fail("rwkv6 population file does not restore bitwise")
    wkv.launches = 0
    outs = serve_cli.main(["--arch", "rwkv6-3b", "--reduced", "--population",
                           "2", "--ckpt", ckpt, "--batch-size", "2",
                           "--seq-len", "32", "--max-new", "8", "--device",
                           str(device)])
    torch.cuda.synchronize()
    log(f"rwkv6 train CLI --ckpt-population -> serve CLI --ckpt (scan "
        f"engine): restored bitwise, served with {wkv.launches} WKV launches "
        f"(expected {2 * cfg.num_layers * 8}: two requests)")
    if (wkv.launches != 2 * cfg.num_layers * 8
            or outs["soup"]["tokens"].shape != (2, 40)):
        fail("the served rwkv6 population's launches or tokens are off")
    wkv.launches = wkv.backward_launches = 0


def build_kernels(*mods):
    """Every library, each nvcc started at once."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        for fut in [pool.submit(mod.build) for mod in mods]:
            fut.result()
    each = ", ".join(f"{mod.SOURCE.stem} {mod.build_seconds or 0:.2f} s"
                     for mod in mods)
    log(f"kernel build: {time.perf_counter() - t0:.2f} s in parallel (nvcc "
        f"{each})")
    for mod in mods:
        for line in sorted({ln.strip() for ln in mod.build_log.splitlines()
                            if "registers" in ln or "spill" in ln}):
            log(f"  ptxas {mod.SOURCE.stem}: {line}")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import wash_shuffle as ws

    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels(pa, ws, fa, wkv)

    kernels = check_kernel(torch, pa, ref, F, device)
    full_width(torch, device, kernels)
    reduced_f32(torch, device, kernels)
    shuffles = check_shuffle_kernels(torch, device)
    train_full_width(torch, device, "llama3.2-3b", shuffles)
    reduced_paths(torch, device, shuffles)
    kernels.update(shuffles)
    kernels.update(check_flash(torch, fa, ref, F, device))
    kernels.update(check_wkv(torch, wkv, ref, device))
    kernels.update(check_wkv_backward(torch, wkv, ref, device))
    scan_engine(torch, device, kernels, card)
    train_full_width(torch, device, "rwkv6-3b", kernels)
    train_rwkv6_reduced(torch, device)
    for entry in kernels.values():
        if entry["launches"] == 0:
            fail(f"kernel {entry['name']} was never launched on its path")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
