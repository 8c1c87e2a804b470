#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``src/repro_torch/kernels/csrc`` and
then, failing on the first phase that fails:

  1. holds the paged-attention kernel against its plain PyTorch version at
     the llama3.2-3b attention geometry (24 heads, 8 kv heads, head dim
     128, 16-token pages, 8 slots, contexts up to 1152 tokens) for bf16,
     int8 and f32 pools, and times the kernel, the plain version and a
     library yardstick (``scaled_dot_product_attention`` on the context
     gathered beforehand, which the port never calls);
  2. serves a mixed request stream through ``ContinuousServer`` in soup
     mode from a population of two full-width llama3.2-3b members (bf16,
     random weights from a seed), checking that every decode attention
     went through the kernel (launches == 28 x decode steps); then a short
     ensemble stream, a short int8-KV stream, and one teacher-forced decode
     step on the kernel path against the plain path;
  3. serves a stream at the reduced float32 config on the kernel path and
     on the plain path: greedy tokens must be identical.

It prints one JSON line ``{"kernels": [...]}``, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# tolerances of the kernel against its plain version, per (q, pool) dtype:
# both accumulate in f32; bf16 outputs differ by the final rounding
# (one bf16 ulp is 2**-8 relative), f32 and int8 outputs by summation order
KERNEL_TOL = {"bf16": 2e-2, "int8": 2e-2, "f32": 2e-5}

# full-width bf16 logits, kernel path against plain path after one decode
# step through 28 layers: bf16 rounding of each layer's attention output
# compounds, so the bound is relative to the logits' range
LOGIT_REL_TOL = 5e-2

# published H100 SXM peaks (NVIDIA data sheet, dense): memory rate and the
# operation rate for the type the kernel computes in
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


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


def check_kernel(torch, pa, ref, F, device):
    """Phase 1.  Returns the kernel entries of the JSON line (launches
    filled in later from the main-path runs)."""
    entries = {}
    for variant in ("bf16", "int8", "f32"):
        q, k, v, table, lengths, ks, vs = kernel_inputs(torch, variant, device)
        err = 0.0
        for layer in (0, LAYERS - 1):
            args = (q[layer], k[layer], v[layer], table, lengths,
                    None if ks is None else ks[layer],
                    None if vs is None else vs[layer])
            got = pa.paged_attention_cuda(*args)
            want = ref.paged_attention_ref(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                fail(f"{variant}: kernel output is not finite")
            err = max(err, float((got.float() - want.float()).abs().max()))
        tol = KERNEL_TOL[variant]
        log(f"kernel {variant}: max |kernel - plain| = {err:.3e} "
            f"(tolerance {tol:g}), lengths {LENGTHS}")
        if err > tol:
            fail(f"paged attention {variant} disagrees with its plain "
                 f"version: {err} > {tol}")

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
        log(f"kernel {variant}: {ms:.4f} ms on the device (again {ms2:.4f}; "
            f"{launch_ms:.4f} ms a call through the Python wrapper), plain "
            f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {ops} ops); "
            f"achieved {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
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
def plain_attention(ops, ref):
    """Route every paged attend through the plain version for the block
    (the comparison path; the kernel's counter does not move)."""
    kernel_route = ops.paged_attention
    ops.paged_attention = ref.paged_attention_ref
    try:
        yield
    finally:
        ops.paged_attention = kernel_route


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
    with plain_attention(ops, ref):
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
    with plain_attention(ops, ref):
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
    with plain_attention(ops, ref):
        plain_server = B.ContinuousServer(soup, cfg, prefill_chunk=16, **geo)
        out_p = plain_server.run(reqs)
    same = all((out_k[r.uid].tokens == out_p[r.uid].tokens).all()
               for r in reqs)
    log(f"reduced f32: greedy tokens kernel path == plain path: {same}")
    if not same:
        fail("reduced f32 greedy tokens differ between kernel and plain path")


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

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    pa.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {pa.build_seconds if pa.build_seconds is not None else 0:.2f} s)")
    for line in sorted({ln.strip() for ln in pa.build_log.splitlines()
                        if "registers" in ln or "spill" in ln}):
        log(f"  ptxas: {line}")

    kernels = check_kernel(torch, pa, ref, F, device)
    full_width(torch, device, kernels)
    reduced_f32(torch, device, kernels)
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
