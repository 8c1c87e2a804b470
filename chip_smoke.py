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
     up to 1152 tokens) for bf16, int8 and f32 pools and f32 queries on
     int8 pools, and times the kernel, the plain version and a library
     yardstick
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
     CLI ``--ckpt-population`` through the serve CLI's ``--ckpt``;
 10. runs the image-classification slice: the quickstart
     (``launch.quickstart.main``: mlp 64 x 3 on 12 x 12 images, N = 4,
     400 steps, baseline and dense WASH p = 0.05), whose pattern must hold
     (the WASH soup within 0.08 of its ensemble, the ensemble above 0.5,
     WASH's consensus below the baseline's), every shuffle through the
     dense kernel (launches == 8 planned leaves x 400); then a ResNet at
     ResNet-18's stage widths (64-512) on 32 x 32 x 3 images (one residual
     block a stage, 4.9 M float32 params a member), N = 3, batch 128 a
     member, heterogeneous augmentation, dense WASH p = 0.05 and a
     baseline, 300 steps: every shuffle through the dense kernel
     (launches == 30 planned leaves x 300), held bitwise against its plain
     version, the comm recorded equal to the float64 count of the masks
     applied, finite losses, WASH's ensemble above twice chance and its
     consensus below the baseline's; the ensemble, uniform-soup,
     greedy-soup, best and worst member accuracies of both; a VGG at the
     same widths, 3 steps of bucketed WASH+Opt under SGD momentum on the
     kernels and on the plain versions (cuDNN deterministic): every
     shuffle bitwise, the final params within 1e-5; and the ResNet's step
     split, images/s and peak memory, one step profiled (the plan draw's
     and the dense shuffle kernel's shares of mixing);
 11. serves under live traffic at full width (llama3.2-3b, bf16, a random
     N = 2 population): 16 requests (prompts of 256-2048 tokens, every
     other on one 512-token prefix, 16-48 new) arriving as a Poisson
     stream at 2 a second through ``serving.driver.RequestDriver`` over a
     soup ``ContinuousServer`` (8 slots, 2048 pages, retained), once with
     whole-prompt prefill and once in 256-token chunks: every request
     finishes, admission is FIFO, paged launches == 28 x decode steps,
     and ``summarize`` gives TTFT p50/p99, inter-token p99, latency p99
     and tokens/s; speculative decoding (k = 4) of 8 requests of 512
     tokens, the ensemble drafted by the soup and the soup drafting for
     itself, each beside its plain server (paged launches == 28 x (k +
     members) x calls; accept ratios and tok/s reported, none asserted);
     the whole-prompt admit of a chunked-attention llama3.2-3b (flash
     launches == 28 x admissions); then at the reduced float32 size,
     tokens identical per request: the driver against ``server.run`` on
     the plain path, speculative (k in 1, 3, 8; soup and ensemble; greedy
     and temperature 0.8) against plain decode and plain decode against
     the plain path, the whole-prompt admit on the kernels against the
     plain path, int8 speculative against int8 plain; finally the serve
     CLI (``--driver --speculative --metrics-out``) at full width, the
     train CLI (``--metrics-out``) at the reduced size, both streams
     through ``tools/check_metrics_schema.py`` (the train stream with
     ``--require-comm``), and a ``--profile-dir`` Chrome trace.
 12. MoE and MLA: holds the flash kernel's (192, 128) instantiation (MLA's
     192-wide queries and keys, 128-wide values) against its plain
     version at DeepSeek-V2-Lite's prefill shape (B=4, S=2048, 16 heads,
     causal; bf16 and f32) and at a ragged non-causal S=1000, and times
     it beside its bound, its plain version and the first fused SDPA
     backend that takes v narrower than q/k (none: null); serves
     full-width deepseek-v2-lite-16b (27 layers, bf16, a random N=2
     population, 60.4 GiB) through the serve CLI's scan engine
     (``--compare``: member, ensemble, then the soup made in place; B=4,
     S=2048, 32 new), checking that every prefill attention went through
     the kernel (launches == 2 requests x 27 x 4 member-runs) and that
     peak allocated memory stays under 80 GB, with prefill s, decode-step
     ms (beside the floor of reading every expert a step) and tok/s per
     mode; one teacher-forced prefill + decode step on the kernel path
     against the plain path; then reduced float32 on the kernels against
     plain, greedy tokens identical: DeepSeek at the full model's MLA
     widths through the scan engine (its own reduced widths refused on
     the card), kimi-k2 (MoE, GQA) through ``ContinuousServer`` (paged
     launches == layers x members x decode steps); finally a full-width
     2-layer teacher-forced prefill + decode step of qwen3-4b, qwen1.5-4b
     and minitron-8b on the kernels against plain.
 13. the hybrid family: holds the selective-scan (Mamba) forward kernel
     against its plain version at hymba-1.5b's prefill shape (B=4,
     T=2048, DI=3200, 16 states) from zero and from a carried state (y
     and the final state), at T=1, at a ragged T=1000 and with extreme dt
     (log-uniform over [1e-4, 30]: exp(dt A) down to an exact 0), and its
     backward (segments of the sequence run at once) at the training
     shape (B=2, T=256; from zero, and from a carried state with a
     final-state grad and extreme dt), at the prefill shape, at a ragged
     T=1000 over eight segments, at hymba's train_4k length and at the
     longest T, 12,288 (carried state, final-state grad), every value
     finite and within 1e-4 of max |plain|, two backward calls bitwise
     equal; times each (CUDA-graph replays) beside its bound, its plain
     version (the backward beside its time before the redesign) and its
     registers, shared memory and spills; holds the flash kernel at
     hymba's prefill attention (bf16, 25 heads over 5 kv heads, head dim
     64, causal, window 1024) and times it beside SDPA with the window
     as a mask; serves full-width hymba-1.5b (8 of its 32 layers, bf16,
     a random N=2 population) through the serve CLI's scan engine
     (``--compare``, B=4, S=2048, 32 new): selective-scan launches == 2
     requests x 8 layers x 4 member-runs x (1 prefill + 31 decode steps),
     flash launches == 2 x 8 x 4; a teacher-forced prefill + decode step on
     the kernel path against the plain path (logits, every layer's output
     and Mamba ``h`` and ``conv``), profiled; trains it through the train
     CLI (bf16, N=2, SGD, bucketed WASH at p=0.01, 2 x 256 tokens a
     member, 4 steps): every Mamba forward and backward through the
     kernels (launches == 32 x 2 x 4, + 32 for the averaged model's
     loss), every shuffle bitwise, the comm exactly ``static_mix_comm``
     (4,155,400.0 scalars a member a step), finite losses, the trained
     soup served, the step split, tokens/s, peak memory and a profiled
     step; then the reduced float32 hymba (window 64) trained 3 steps at
     128 tokens on the kernels and on the plain versions (params within
     1e-5), and served through ``engine.generate`` (soup, ensemble;
     greedy tokens identical); a state size the scan kernel lacks is
     refused on the card.
 14. the last model families: holds the flash kernel at whisper-medium's
     encoder (B=4, 1500 frames, 16 heads of 64, non-causal) and decoder
     prefill (B=4, 224 positions, 16 heads of 64, causal), each in bf16
     and f32, and at internvl2-76b's prefill behind its patches (B=4,
     256 + 2048 positions, 64 query heads over 8 kv heads of 128,
     causal; bf16) against its plain version and times it beside its
     bound and SDPA; serves full-width whisper-medium (24 encoder and 24
     decoder layers, bf16, a random N=2 population) through the serve
     CLI's scan engine (``--compare``, B=4, 1500 frames, a 224-token
     prompt, 32 new): flash launches == 2 requests x 24 layers x 4
     member-runs at the encoder's shape and as many at the decoder's,
     each counted under its own entry; trains it through the train CLI
     (N=2, SGD, bucketed WASH at p=0.01, 2 x 256 tokens and 1500 frames a
     member, 4 steps; every shuffle bitwise, the comm exactly
     ``static_mix_comm``, 2,460,113.0 scalars a member a step) and serves
     the trained soup; trains DeepSeek-V2-Lite at full width and 4 of its
     27 layers the same way through the train loop (its MLA trains on
     plain attention) and serves its trained soup through the (192, 128)
     flash prefill; serves internvl2-76b at full width and 4 of its 80
     layers as the soup (B=4, 256 patches + 2048 prompt, 32 new; flash
     launches == 2 x 4); then the reduced float32 whisper (at its full
     attention widths and 1500 frames, a 224-token prompt), internvl2
     and DeepSeek (at its full MLA widths) on the kernels against plain:
     3 steps of bucketed WASH with params within 1e-5, and greedy tokens
     identical in soup and ensemble.
 15. multi-device training: the ensemble engine (``--engine shard_map``)
     at world 1 on the card (NCCL refuses two ranks on one device, so the
     ring across ranks is not run here).  Full-width llama3.2-3b (bf16,
     N = 2, SGD, bucketed WASH at p = 0.01, 2 x 256 tokens a member, 4
     steps, a record every 2) through the train CLI's ``main``: every
     shuffle through the bucketed kernel (launches == 10 leaves x 4
     steps), each held bitwise against the plain version, the comm
     exactly 9,016,867.0 scalars a member a step, one chunk function
     built, finite losses within 1e-2 relative of phase 5's vmap loop;
     the same run unchecked through the vmap loop, the engine with the
     staging thread and the engine with ``--sync-staging``, interleaved
     for two rounds, for the step split, tokens/s and peak memory; then
     llama3.2-3b at full width and 4 layers in
     float32 on the kernels, the engine against the vmap loop (params
     within 1e-5): bucketed WASH+Opt under AdamW, PAPA with and without
     the gate split (the chunk functions built counted), synchronous
     staging against the staging thread; finally an engine asked for two
     ranks on the one card is refused before any weight is made.
 16. training on ens x data x model meshes: phase 15's full-width run
     through the train CLI with ``--mesh ens_dp_mp`` at world 1 (the
     fill gives the (1, 1, 1) mesh: the shard-local planner runs, the
     single-axis body trains), held to phase 15: losses equal, 40
     bucketed launches each bitwise, 9,016,867.0 scalars a step, one
     chunk function, the peak memory; then, on the host, the planner's
     comm (held to the reference's to the last digit) and what a card
     holds for the four-card layouts (2,1,2), (1,1,4), (2,2,1).
 17. the pipeline axis in training: phase 15's full-width run through the
     train CLI with ``--mesh ens_pp --microbatches 2`` at world 1 (the
     fill gives (1, 1): the GPipe schedule runs on one stage with no
     exchange), held to phase 15: 40 bucketed launches each bitwise,
     9,016,867.0 scalars a step, one chunk function, losses within 1e-2
     relative; the peak memory and the step split (forward and backward
     ticks); then the 4-layer float32 cut through the CLI: one
     microbatch bitwise equal to phase 15's engine, two within 2e-5 of
     the vmap loop; finally ``--pp-stages 2`` on the one card is refused
     before any weight is made.
 18. stage-split and data-mesh serving at world 1: full-width llama3.2-3b
     (bf16, the soup of a random N=2 population, B=4, S=2048, 32 new)
     through the serve CLI without a mesh, with ``--mesh data`` (the (1,)
     data group) and with ``--pp-stages 1``: tokens equal, flash launches
     == 2 requests x 28 layers each run; the stage functions composed
     over 4 virtual stages of 7 layers on the one card, the prefill's
     logits and 31 greedy tokens bitwise the unstaged engine's, flash
     launches == 28 a prefill; the serve CLI's ``--pp-stages 2`` on the
     one card refused before any weight is made.
 19. the dry run and the analysis lane: ``launch/dryrun.py`` on meta
     tensors predicts the per-card peak of phases 5, 8 and 15 at full
     width, printed beside each measured peak, with
     ``torch.cuda.memory_allocated()`` unchanged across it; the serving
     entries of ``analysis/matrix.py`` (scan, continuous and speculative
     decode) held to their contracts on the card, with their host syncs
     per decode step; the syncs per decode step of phase 8's llama3.2-3b
     request, by call site; the lints over ``src/repro_torch``.

Phase 13's full-width hymba serve and teacher-forced step run 8 of its 32
layers (``HYMBA_SERVE_LAYERS``), to make room for phase 18; phase 11
serves 16 requests (24 before phase 19), at the same rate.

Kernels are built from the sources in the checkout, each ``nvcc`` started
at once.  It prints one JSON line ``{"kernels": [...]}``, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import collections
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
KERNEL_TOL = {"bf16": 2e-2, "int8": 2e-2, "f32": 2e-5, "f32-int8": 2e-5}

# peak device memory (GiB) of the runs phase 19's dry run predicts, by
# phase: 5 (the llama3.2-3b training re-run), 8 (the llama3.2-3b scan
# request, every mode), 15 (the engine's re-runs)
PEAK_GIB: dict = {}

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
PEAK_OPS = {"bf16": 989e12, "f32": TF32_OPS / 3, "int8": 1979e12,
            "f32 FFMA": FFMA_OPS}  # a float32 kernel off the tensor cores


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
    q and pool dtypes ("f32-int8": f32 queries on int8 pools)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    max_pages = -(-max(LENGTHS) // PAGE)
    P = SLOTS * max_pages + 1
    perm = torch.randperm(P - 1, generator=gen, device=device) + 1
    table = perm[:SLOTS * max_pages].reshape(SLOTS, max_pages).to(torch.int32)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=device)
    qdt = torch.float32 if variant.startswith("f32") else torch.bfloat16
    q = torch.randn(LAYERS, SLOTS, H, HD, generator=gen, device=device).to(qdt)
    shape = (LAYERS, P, PAGE, KV, HD)
    k = torch.randn(shape, generator=gen, device=device)
    v = torch.randn(shape, generator=gen, device=device)
    if variant.endswith("int8"):
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
    kv_elem = {"bf16": 2, "f32": 4, "int8": 1, "f32-int8": 1}[variant]
    q_elem = 4 if variant.startswith("f32") else 2
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
    for variant in ("bf16", "int8", "f32", "f32-int8"):
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
        # f32 queries on int8 pools compute in float32
        t_ops = ops / PEAK_OPS[variant.split("-")[0]] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"kernel {variant}: {ms:.4f} ms on the device, a call's two "
            f"launches (again {ms2:.4f}; {launch_ms:.4f} ms a call through "
            f"the Python wrapper), plain {plain_ms:.4f} ms, library (SDPA) "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes} B, {ops} ops); achieved "
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
        entries[variant] = {
            "name": f"paged_attention[q="
                    f"{'f32' if variant.startswith('f32') else 'bf16'},kv="
                    f"{variant.split('-')[-1]}]",
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
    ``flash_attention``, ``rwkv6_scan``, ``selective_scan``) through its
    plain version for the block (the comparison path; the kernels'
    counters do not move)."""
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
# the dense kernel's device ms before its redesign (a word a row a thread,
# a launch a leaf; proof run 29, H100 80GB HBM3 at 700.00 W): phase 6's
# blocks.mlp.w1 out of place, and the profiled ResNet step's 30 launches
DENSE_EARLIER_MS = {"w1": 1.0208, "resnet_step": 0.180}
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


def shuffle_bytes_dense(n, d, elt, mask_count, in_place=False):
    """x read and out written once, the mask once, perm only where the
    mask is set (the function needs no other perm entry); ``in_place``,
    only the masked columns read and written: ``kernels/work.py``, which
    the dry run counts with too."""
    from repro_torch.kernels import work

    return work.shuffle_bytes_dense(n, d, elt, mask_count, in_place)


def shuffle_bytes_bucketed(n, k_per, elt):
    """Each selected column of buckets 1..N-1 read and written once (N
    values each), plus its plan entry (``kernels/work.py``)."""
    from repro_torch.kernels import work

    return work.shuffle_bytes_bucketed(n, k_per, elt)


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
    # the dense kernel grouped and in place: vector-path and scalar-path
    # leaves of both word sizes in one call, one launch a word size
    widths = (1, 7, 64, 1000, 4099, 4096, 65536, d)
    for n in (2, 3, 16):
        xs, perms, masks, wants = [], [], [], []
        for i, (dtype, w) in enumerate((dt, w) for dt in (torch.float32,
                                                          torch.bfloat16)
                                       for w in widths):
            xs.append(_randn(torch, n, w, dtype, device, seed=70 + i))
            perm, mask = shf.dense_plan(70 + i, (w,), n, 0.3, device)
            perms.append(perm)
            masks.append(mask)
            wants.append(ref.wash_shuffle_ref(xs[-1], perm, mask))
        n0 = (ws.wash_launches, ws.wash_leaves)
        ws.wash_shuffle_many_cuda_(xs, perms, masks)
        torch.cuda.synchronize()
        grouped = (ws.wash_launches - n0[0], ws.wash_leaves - n0[1])
        for x, want, w in zip(xs, wants, widths * 2):
            hold("dense", x, want, f"grouped in place, N={n} {x.dtype} D={w}")
        if grouped != (2, len(xs)):
            fail(f"grouped dense shuffle: {grouped} launches and leaves, "
                 f"expected (2, {len(xs)})")
    ws.wash_launches = ws.wash_leaves = 0
    log(f"dense shuffle grouped and in place: bitwise equal to its plain "
        f"version leaf by leaf at N in (2, 3, 16), D in {widths}, f32 and "
        f"bf16 leaves in one call, one launch a word size")

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
    n0 = (ws.wash_launches, ws.wash_leaves)
    ms = device_ms(torch, lambda _: ws.wash_shuffle_cuda(x, perm, mask), 1)
    plain_ms = device_ms(torch, lambda _: ref.wash_shuffle_ref(x, perm, mask),
                         1)
    yard_ms = device_ms(torch, lambda _: torch.where(
        mask, torch.gather(x, 0, perm64), x), 1)
    ms2 = device_ms(torch, lambda _: ws.wash_shuffle_cuda(x, perm, mask), 1)
    call_ms = wall_ms(torch, lambda: ws.wash_shuffle_cuda(x, perm, mask), 20, 2)
    # in place (the training path's call): only the masked columns move
    place_ms = device_ms(torch, lambda _: ws.wash_shuffle_many_cuda_(
        [x], [perm], [mask]), 1)
    ws.wash_launches, ws.wash_leaves = n0
    nnz = int(mask.sum())
    nbytes = shuffle_bytes_dense(2, x.shape[1], 4, nnz)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    place_bytes = shuffle_bytes_dense(2, x.shape[1], 4, nnz, in_place=True)
    place_bound = place_bytes / HBM_BYTES_PER_S * 1e3
    log(f"dense shuffle, blocks.mlp.w1 at {layers} layers N=2 f32 ({nnz} of "
        f"{x.shape[1]} columns masked), device time: kernel {ms:.4f} ms out "
        f"of place (again {ms2:.4f}; {call_ms:.4f} ms a call through the "
        f"Python wrapper; before the redesign {DENSE_EARLIER_MS['w1']:.4f} "
        f"ms, proof run 29), in place {place_ms:.4f} ms (bound "
        f"{place_bound:.4f} ms by bytes, {place_bytes} B: the mask, and the "
        f"masked columns read and written), plain {plain_ms:.4f} ms, "
        f"yardstick gather+where on an int64 perm {yard_ms:.4f} ms (no "
        f"single PyTorch call computes the function), bound {bound:.4f} ms "
        f"by bytes out of place ({nbytes} B); achieved "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s; "
        f"{attributes_line(ws.kernel_attributes(4, 2))}")
    entries["dense"] = {
        "name": "wash_shuffle[f32,N=2,blocks.mlp.w1 at 4 layers]",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/wash_shuffle.cu",
        "replaces": "src/repro/kernels/wash_shuffle.py:40",
        "launches": 0, "leaves": 0, "max_abs_err": err["dense"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": None, "yardstick_ms": yard_ms,
        "in_place_ms": place_ms, "in_place_bound_ms": place_bound}
    del x, perm, mask, perm64
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phases 5 and 9: full-width training, then the trained soup served
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_SEQ = 4, 256    # phases 5, 9: steps, tokens a sequence
# per arch trained at full width: the leaves that get a plan, and the
# scalars sent per member a mixing step (also its static_mix_comm)
TRAIN_PLANS = {"llama3.2-3b": (10, 9016867.0), "rwkv6-3b": (18, 7670170.0),
               "hymba-1.5b": (19, 4155400.0),
               "whisper-medium": (28, 2460113.0),
               "deepseek-v2-lite-16b-4layers": (16, 6897044.0)}


@contextlib.contextmanager
def checked_shuffles(ops, ref, torch, counts):
    """Every shuffle on the kernel route is also run through the plain
    version on the same inputs and must be bitwise equal; ``counts``
    tallies the comparisons, a leaf each (the kernels' launch counters
    move as they would without the check)."""
    dense, bucketed = ops.wash_shuffle, ops.bucketed_shuffle_
    many = ops.wash_shuffle_many_

    def dense_checked(x, perm, mask):
        out = dense(x, perm, mask)
        if not _same(torch, out, ref.wash_shuffle_ref(x, perm, mask)):
            fail("training: a dense shuffle differs from its plain version")
        counts["dense"] += 1
        return out

    def many_checked(xs, perms, masks):
        wants = [ref.wash_shuffle_ref(*a) for a in zip(xs, perms, masks)]
        many(xs, perms, masks)
        if not all(_same(torch, x, w) for x, w in zip(xs, wants)):
            fail("training: a dense shuffle differs from its plain version")
        counts["dense"] += len(xs)
        return xs

    def bucketed_checked(x, idx):
        want = ref.bucketed_shuffle_ref(x, idx)
        bucketed(x, idx)
        if not _same(torch, x, want):
            fail("training: a bucketed shuffle differs from its plain version")
        counts["bucketed"] += 1
        return x

    ops.wash_shuffle, ops.bucketed_shuffle_ = dense_checked, bucketed_checked
    ops.wash_shuffle_many_ = many_checked
    try:
        yield
    finally:
        ops.wash_shuffle, ops.bucketed_shuffle_ = dense, bucketed
        ops.wash_shuffle_many_ = many


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


def timed_training_run(torch, run, what: str) -> dict:
    """The training run ``run()`` once more without the checks: the step's
    split, tokens/s and peak memory, logged and returned."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run()
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
    return {"split_ms": ph, "tok_s": tokens / wall,
            "steps2_ms": sum(sum(ph[p][1:]) for p in ph) / max(steps - 1, 1),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def train_full_width(torch, device, arch, kernels, cfg=None):
    """Phases 5 (llama3.2-3b), 9 (rwkv6-3b), 13 (hymba-1.5b) and 14
    (whisper-medium; DeepSeek-V2-Lite cut in depth): the arch at full width,
    or ``cfg`` (a cut of it that no flag expresses), through the train
    CLI's ``main`` on ``training_argv``, every shuffle held bitwise
    against its plain version.  Checks the
    bucketed launches (``TRAIN_PLANS`` leaves a step), the comm the
    applied plans send a step (``TRAIN_PLANS`` and ``static_mix_comm``),
    finite losses, and the recurrence kernels' launches (rwkv6's WKV,
    hymba's selective scan: a forward and a backward a layer, member and
    step, with ``remat_blocks`` a second forward; none for llama); for
    the attention archs one leaf's coordinate multisets across a shuffle.
    Then the trained soup is served (llama: ``ContinuousServer``; the
    others: the scan engine), the same run made again unchecked for the
    step's split, tokens/s and peak memory, and one more step profiled.
    Sets the launches of the kernels the phase owns in ``kernels`` (rwkv6:
    the WKV backward; hymba: the selective-scan backward, and its
    forward's are added; the attention archs add to the bucketed
    shuffle's).  Returns the checked run's losses by step and the
    unchecked run's timing (``timed_training_run``)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import layer_index as tli
    from repro_torch.core.mixing import MixingConfig, static_mix_comm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as M
    from repro_torch.serving.engine import averaged_params

    argv = training_argv(arch, device)
    route = "launch.train.main" + ("" if cfg is None else
                                   f" on the cut config {cfg.name}")
    if cfg is None:
        cfg = get_arch(arch)

    def run():
        return train_cli.main(argv, cfg=cfg)
    rwkv = cfg.block_kind == "rwkv6"
    scan = {"rwkv6": wkv, "hybrid": ssk}.get(cfg.block_kind)
    scan_name = {"rwkv6": "WKV", "hybrid": "selective-scan"}.get(
        cfg.block_kind, "recurrence")
    steps, seq, n = TRAIN_STEPS, TRAIN_SEQ, 2
    leaves, step_comm = TRAIN_PLANS[cfg.name]
    shapes = M.param_shapes(cfg)
    static = static_mix_comm(
        shapes, MixingConfig(kind="wash", base_p=0.01, mode="bucketed"),
        tli.infer_layer_ids(shapes, cfg.num_layers),
        tli.total_layers(cfg.num_layers), n)
    # llama, hymba, whisper: the stacked blocks.attn.wk (or a leaf of its
    # width) is copied across its first shuffle; MLA: blocks.attn.w_dkv
    # (or its twin w_uk) (width 0: no leaf is copied, only the applied
    # plans' shapes kept)
    wk = 0 if rwkv else cfg.num_layers * cfg.d_model * (
        cfg.kv_lora_rank if cfg.mla else
        cfg.num_kv_heads * cfg.resolved_head_dim)
    # rwkv6, hymba: a recurrence forward and backward a layer, member and
    # step (with remat_blocks, the forward twice); the CLI then evaluates
    # the averaged model's loss, a forward a layer
    expect = cfg.num_layers * n * steps if scan else 0
    expect_fwd = (expect * (2 if cfg.remat_blocks else 1) + cfg.num_layers
                  if scan else 0)
    seen, counts = {"plans": []}, {"dense": 0, "bucketed": 0}
    torch.cuda.synchronize()
    ws.bucketed_launches = ws.wash_launches = pa.launches = 0
    _zero(fa, wkv, pa)
    wkv.backward_launches = ssk.backward_launches = 0
    t0 = time.perf_counter()
    with checked_shuffles(ops, ref, torch, counts), \
            watch_bucketed_shuffles(ops, wk, seen):
        res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ws.bucketed_launches
    fwd, bwd = ((scan.launches, scan.backward_launches) if scan
                else (0, 0))
    other = _counts(fa, wkv, pa)
    other.pop({"rwkv6": "wkv", "hybrid": "ssm"}.get(cfg.block_kind), None)
    log(f"training ({cfg.name}, {cfg.num_layers} layers, {cfg.dtype}, "
        f"N={n}, SGD, bucketed WASH p=0.01, 2 x {seq} tokens per member, "
        f"{steps} steps) through {route}, every shuffle held "
        f"against its plain version: {wall:.2f} s; bucketed shuffle "
        f"launches {launches} (expected {leaves} x {steps}), "
        f"{counts['bucketed']} of them bitwise equal to the plain version "
        f"on the same inputs, dense {ws.wash_launches}; {scan_name} "
        f"forward launches {fwd} (expected {expect_fwd}"
        + (f": {cfg.num_layers} layers x {n} members x {steps} steps, + "
           f"{cfg.num_layers} for the averaged model's loss" if scan else "")
        + f"), backward calls {bwd} (expected {expect}); other kernels' "
        f"launches {other} (expected none); losses "
        f"{res.history['loss']}; comm {res.history['comm']}")
    if (launches != leaves * steps or ws.wash_launches
            or counts["bucketed"] != launches):
        fail(f"{arch} training: {launches} bucketed launches "
             f"({counts['bucketed']} checked) for {steps} steps of {leaves} "
             f"planned leaves ({ws.wash_launches} dense)")
    if (fwd, bwd) != (expect_fwd, expect) or any(other.values()):
        fail(f"{arch} training: {fwd} {scan_name} forward launches and "
             f"{bwd} backward calls, expected {expect_fwd} and {expect}; "
             f"other kernels {other}")
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
            fail(f"training: no bucketed shuffle of a leaf of width {wk} "
                 "was seen")
        moved = int((before != after).any(dim=0).sum())
        same = torch.equal(torch.sort(before, dim=0).values,
                           torch.sort(after, dim=0).values)
        log(f"the first stacked leaf of width {wk} across one shuffle: "
            f"{moved} of {before.shape[1]} columns changed; each column's "
            f"multiset of member values unchanged: {same}")
        if not same or moved == 0:
            fail("training: the shuffle did not preserve each coordinate's "
                 "multiset, or moved nothing")
        del before, after
    del seen
    losses = dict(zip(res.history["step"], res.history["loss"]))
    if rwkv:
        kernels["wkv_bwd"]["launches"] = bwd
    elif scan:
        kernels["ssm"]["launches"] += fwd
        kernels["ssm_bwd"]["launches"] += bwd
    else:
        kernels["bucketed"]["launches"] += launches

    soup = averaged_params(res)
    del res
    torch.cuda.empty_cache()
    serve_trained_soup(torch, device, cfg, soup)
    del soup
    torch.cuda.empty_cache()

    timing = timed_training_run(torch, run, f"{cfg.name} training")
    torch.cuda.empty_cache()
    profile_training_step(torch, device, cfg, kernels)
    _zero(fa, wkv, pa)
    wkv.backward_launches = ssk.backward_launches = 0
    torch.cuda.empty_cache()
    return {"loss": losses, "timing": timing}


def serve_trained_soup(torch, device, cfg, soup):
    """llama: 4 requests through ``ContinuousServer``; the configs it does
    not take: 2 prompts of TRAIN_SEQ tokens and 8 new tokens through the
    scan engine (a WKV or selective-scan launch a layer for the prefill
    and each of the 7 decode steps, no backward; the flash kernel once an
    attention layer, encoder layers included, in the prefill)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.launch.serve import mixed_stream
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import transformer as M
    from repro_torch.serving import batching as B
    from repro_torch.serving import engine

    seq = TRAIN_SEQ
    if M.paged_decode_supported(cfg) is None:
        server = B.ContinuousServer(soup, cfg, mode="soup", page_size=16,
                                    max_slots=4, num_pages=128,
                                    max_pages_per_slot=-(-(seq + 16) // 16),
                                    device=device)
        serve_stream(torch, pa, server, mixed_stream(cfg, 4, seq, 16,
                                                     seed=12),
                     "trained soup stream (full width)", cfg.num_layers)
        return
    batch = concrete_batch(cfg, 21, 2, seq, device=device)
    hybrid, rwkv = cfg.block_kind == "hybrid", cfg.block_kind == "rwkv6"
    expect = {"flash": 0 if rwkv else cfg.num_layers + cfg.encoder_layers,
              "paged": 0, "wkv": cfg.num_layers * 8 if rwkv else 0,
              "ssm": cfg.num_layers * 8 if hybrid else 0}
    _zero(fa, wkv, pa)
    wkv.backward_launches = ssk.backward_launches = 0
    with torch.no_grad():
        toks = engine.generate(soup, cfg, batch, 8, device=device)
    torch.cuda.synchronize()
    counts = _counts(fa, wkv, pa)
    backward = wkv.backward_launches + ssk.backward_launches
    log(f"trained {cfg.name} soup through the scan engine (B=2, S={seq}, "
        f"8 new tokens): launches {counts} (expected {expect}), backward "
        f"calls {backward}")
    if (toks.shape != (2, seq + 8) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size
            or not torch.equal(toks[:, :seq], batch["tokens"].to(toks.dtype))):
        fail(f"trained {cfg.name} soup: tokens of shape {tuple(toks.shape)}")
    if counts != expect or backward:
        fail(f"trained {cfg.name} soup: the scan engine's launches are off")


def profile_training_step(torch, device, cfg, kernels):
    """One full-width training step (the third of three) under
    ``torch.profiler``: device time by operator and the device's busy
    share of the step's wall time (the step ends in a synchronizing
    read of the loss; the profiler's own host cost is in the wall time,
    so the idle share is an upper bound).  For the hybrid family, the
    selective-scan backward's launches a call, into ``kernels``."""
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
        bwd = backward_profile(prof, "_RWKV6ScanBackward",
                               wkv.BACKWARD_KERNELS)
        log(f"profiled {cfg.name} training step: the WKV backward {bwd} "
            f"(the earlier two-pass kernel: _RWKV6ScanBackward 28.1 ms x 64)")
    if cfg.block_kind == "hybrid":
        from repro_torch.kernels import selective_scan as ssk
        bwd = backward_profile(prof, "_SelectiveScanBackward",
                               ssk.BACKWARD_KERNELS)
        log(f"profiled {cfg.name} training step: the selective scan {bwd} "
            f"(the backward before its redesign in segments: "
            f"_SelectiveScanBackward 13.22 ms x 64)")
        calls = op_calls(prof, "_SelectiveScanBackward")
        launched = sum(n for _, n in kernel_us(
            prof, ssk.BACKWARD_KERNELS).values())
        if not calls or not launched:
            fail(f"profiled {cfg.name} training step: {calls} selective-scan "
                 f"backward calls, {launched} launches of "
                 f"{ssk.BACKWARD_KERNELS}")
        kernels["ssm_bwd"]["launches_per_call"] = launched / calls


def backward_profile(prof, op_name, names) -> str:
    """From a finished ``torch.profiler`` run: the device time of the
    autograd operator ``op_name`` (a recurrence backward's calls) and of
    each of the kernels ``names`` by name, totals over the run."""
    op = _op(prof, op_name)
    total = (f"{op_name} {op.self_device_time_total / 1e3:.2f} "
             f"ms x{op.count}" if op is not None else f"{op_name} not seen")
    return total + "; by kernel: " + ", ".join(
        f"{name} {us / 1e3:.2f} ms x{n}"
        for name, (us, n) in kernel_us(prof, names).items())


def _op(prof, op_name):
    """The host operator ``op_name``'s totals in a finished
    ``torch.profiler`` run, or None."""
    from torch.autograd import DeviceType

    return next((a for a in prof.key_averages()
                 if a.device_type == DeviceType.CPU and a.key == op_name),
                None)


def op_calls(prof, op_name) -> int:
    """How often the host operator ``op_name`` ran in a finished
    ``torch.profiler`` run."""
    op = _op(prof, op_name)
    return 0 if op is None else op.count


def device_activity(prof, n_top: int = 10):
    """From a finished ``torch.profiler`` run: the device's busy time (ms,
    the union of its activity intervals; the launch queue's "Command
    Buffer Full" markers are the host waiting, and the device-side copies
    of annotations, the profiler's ``ProfilerStep#`` and any
    ``record_function`` range, span idle time: neither is device work),
    the number of activities, how often the host found the queue full,
    and the device time of the top operators."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full"
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("ProfilerStep"))
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
    saved = ops.wash_shuffle, ops.bucketed_shuffle_, ops.wash_shuffle_many_
    ops.wash_shuffle, ops.bucketed_shuffle_, ops.wash_shuffle_many_ = (
        ref.wash_shuffle_ref, ref.bucketed_shuffle_ref_,
        ref.wash_shuffle_many_ref_)
    try:
        yield
    finally:
        ops.wash_shuffle, ops.bucketed_shuffle_, ops.wash_shuffle_many_ = saved


def _train(cfg, mcfg, optimizer, steps, device, seq=64, record_fn=None,
           engine="vmap", **engine_opts):
    """The train loop (or, with ``engine="shard_map"``, the ensemble
    engine at world 1, with ``engine_opts``) on N = 2 members, 2 x ``seq``
    tokens a member a step of the synthetic LM task (with the frontend's
    frames or patches from ``concrete_batch``, as the train CLI draws
    them)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.prng import fold_in
    from repro_torch.data import make_lm_task, sample_tokens
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import transformer as M
    from repro_torch.train.loop import train_population

    task = make_lm_task(fold_in(0, 1), vocab=min(cfg.vocab_size, 512),
                        device=device)

    def data_fn(m, step, s):
        b = (concrete_batch(cfg, fold_in(s, 10), 2, seq, device=device)
             if cfg.frontend else {})
        b["tokens"] = sample_tokens(task, s, 2, seq)
        return b

    tcfg = TrainConfig(population=2, optimizer=optimizer, total_steps=steps,
                       lr=3e-4 if optimizer == "adamw" else 0.05, seed=0)
    return train_population(
        0, lambda s: M.init_params(cfg, seed=s, device=device),
        lambda p, b: M.loss_fn(p, cfg, b)[0], data_fn, tcfg, mcfg,
        cfg.num_layers, record_every=1 if record_fn else steps,
        record_fn=record_fn, device=device, engine=engine,
        engine_opts=engine_opts or None)


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
        ws.wash_launches = ws.bucketed_launches = ws.wash_leaves = 0
        t0 = time.perf_counter()
        with checked_shuffles(ops, ref, torch, counts):
            res = _train(cfg, mcfg, optimizer, steps, device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"dense": ws.wash_launches, "bucketed": ws.bucketed_launches}
        leaves = ws.wash_leaves
        moments = 2 if optimizer == "adamw" else 1
        per_step = TRAIN_PLANS[base.name][0] * (
            1 + moments if mcfg.kind == "wash_opt" else 1)
        expected = {"dense": 0, "bucketed": 0}
        # dense: a step's planned leaves (all f32) in one launch
        expected[kernel] = steps if kernel == "dense" else per_step * steps
        want_leaves = per_step * steps if kernel == "dense" else 0
        kept = pop.tree_map(torch.clone, res.population)
        losses = res.history["loss"]
        del res
        with plain_shuffles(ops, ref):
            plain = _train(cfg, mcfg, optimizer, steps, device)
        diff = max(float((a - b).abs().max()) for a, b in zip(
            pop.tree_leaves(kept), pop.tree_leaves(plain.population)))
        log(f"{cfg.name}, {what}, {steps} steps: {dt:.2f} s; kernel launches "
            f"{launches} (expected {expected}), dense leaves {leaves} "
            f"(expected {want_leaves}); {counts[kernel]} shuffled leaves "
            f"bitwise equal to their plain versions on the training inputs; "
            f"max |param kernel run - plain run| = {diff:.3e} (tolerance "
            f"{PARAM_TOL:g}); losses {losses} vs {plain.history['loss']}")
        if (launches != expected or leaves != want_leaves
                or counts[kernel] != per_step * steps):
            fail(f"{what}: launches {launches}, dense leaves {leaves}, "
                 f"checks {counts}, expected {expected}, {want_leaves}")
        if diff > PARAM_TOL or not np.isfinite(losses).all():
            fail(f"{what}: kernel and plain runs differ by {diff}")
        if kernel == "dense":  # the dense kernel's path is this run
            kernels["dense"]["launches"] = launches["dense"]
            kernels["dense"]["leaves"] = leaves
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


def flash_inputs(torch, B, S, H, KV, hd, dt, device, seed, hv=None):
    """q (B, S, H, hd), k (B, S, KV, hd), v (B, S, KV, hv), hv = hd unless
    given."""
    gen = _gen(torch, device, seed)
    dtype = getattr(torch, _DTYPES[dt])
    return tuple(torch.randn(B, S, n, d, generator=gen, device=device)
                 .to(dtype) for n, d in ((H, hd), (KV, hd),
                                         (KV, hd if hv is None else hv)))


def flash_work(B, S, H, KV, hd, dt, causal, window=None, hv=None):
    """Bytes (q, k, v read once, out written once) and operations (QK^T
    over hd and PV over hv = hd unless given, a multiply and an add each,
    over the visible pairs only): ``kernels/work.py``."""
    from repro_torch.kernels import work

    return work.flash_work(B, S, H, KV, hd, 2 if dt == "bf16" else 4,
                           causal, window, hv)


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
    factors as v_j * sum_i r_i u_i k_i, O(hd) per step):
    ``kernels/work.py``."""
    from repro_torch.kernels import work

    return work.wkv_work(B, T, H, hd)


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
    four sums G v, k G, G S and S dy, 2 each): ``kernels/work.py``."""
    from repro_torch.kernels import work

    return work.wkv_bwd_work(B, T, H, hd, carried)


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
    from repro_torch.kernels import selective_scan as ssk

    return {"flash": fa.launches, "wkv": wkv.launches, "paged": pa.launches,
            "ssm": ssk.launches}


def _zero(fa, wkv, pa):
    from repro_torch.kernels import selective_scan as ssk

    fa.launches = wkv.launches = pa.launches = ssk.launches = 0
    fa.launch_shapes.clear()


def serve_full_width(torch, device, arch, card, seq=SCAN_S, cfg=None):
    """The serve CLI without --continuous, --compare: each mode served
    twice (its first request and the timed one) from a random N = 2
    population, B = SCAN_B prompts of ``seq`` tokens, of ``arch``'s
    config or of ``cfg`` (a depth cut of it, through ``main(argv,
    cfg=...)``).  Returns the launches of the run, checked exactly."""
    from repro_torch.configs import get_arch
    from repro_torch.core.prng import fold_in
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.core.population import tree_leaves
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import transformer as M

    cfg = get_arch(arch) if cfg is None else cfg
    members = sum(MODE_MEMBERS.values())
    shapes = tree_leaves(M.param_shapes(cfg))
    one_model = sum(x.numel() * x.element_size() for x in shapes)
    # a member-run's layer calls: its prefill and SCAN_NEW - 1 decode steps
    runs = REQUESTS_PER_MODE * cfg.num_layers * members
    if cfg.block_kind == "rwkv6":  # every time mix, prefill and decode
        expect = {"flash": 0, "paged": 0, "wkv": runs * SCAN_NEW, "ssm": 0}
    else:  # every prefill attention (decode attends with plain sdpa; an
        # encoder's layers attend once a prefill), and a hybrid layer's
        # Mamba recurrence in prefill and every decode step
        expect = {"flash": runs + REQUESTS_PER_MODE * cfg.encoder_layers
                  * members, "paged": 0, "wkv": 0,
                  "ssm": runs * SCAN_NEW if cfg.block_kind == "hybrid"
                  else 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(fa, wkv, pa)
    t0 = time.perf_counter()
    outs = serve_cli.main(["--arch", arch, "--population", "2", "--seed", "0",
                           "--batch-size", str(SCAN_B), "--seq-len",
                           str(seq), "--max-new", str(SCAN_NEW),
                           "--compare"], cfg=cfg)
    torch.cuda.synchronize()
    counts = _counts(fa, wkv, pa)
    dt = time.perf_counter() - t0
    enc = (f" + {cfg.encoder_layers} encoder layers over {cfg.num_frames} "
           f"frames" if cfg.is_encdec else "")
    log(f"scan engine {arch} (full width, {cfg.num_layers} layers{enc}, "
        f"{cfg.dtype}, N=2, B={SCAN_B}, S={seq}, max_new {SCAN_NEW}, "
        f"every mode twice): {dt:.2f} s with the population's init; kernel "
        f"launches {counts} (expected {expect}: {REQUESTS_PER_MODE} requests "
        f"x ({cfg.num_layers}{f' + {cfg.encoder_layers}' if enc else ''}) "
        f"layers x {members} member-runs"
        + (f" x (1 prefill + {SCAN_NEW - 1} decode steps) for the "
           f"recurrence" if cfg.block_kind != "attn" else "")
        + f"); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{sum(x.numel() for x in shapes)} parameters, {one_model} B a "
        f"member ({one_model / 2**30:.2f} GiB): a decode step's floor "
        f"{one_model / HBM_BYTES_PER_S * 1e3:.3f} ms a model")
    PEAK_GIB[f"scan {arch}"] = torch.cuda.max_memory_allocated() / 2**30
    if counts != expect:
        fail(f"{arch}: kernel launches {counts}, expected {expect}")
    prompts = concrete_batch(cfg, fold_in(0, 2), SCAN_B, seq,
                             device=device)["tokens"]
    for mode, res in outs.items():
        toks = res["tokens"]
        if toks.shape != (SCAN_B, seq + SCAN_NEW):
            fail(f"{arch} {mode}: tokens of shape {tuple(toks.shape)}")
        if not torch.equal(toks[:, :seq].long(), prompts.long()):
            fail(f"{arch} {mode}: the prompt was not kept")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            fail(f"{arch} {mode}: sampled out of the vocabulary")
        log(f"scan engine {arch} {mode}: {res['tok_s']:.2f} tok/s (B="
            f"{SCAN_B} x {SCAN_NEW} new tokens in {res['steady_s']:.3f} s, "
            f"prefill of {seq} tokens included: prefill "
            f"{res['prefill_s']:.3f} s, decode step "
            f"{res['decode_step_ms']:.2f} ms; first request "
            f"{res['first_s']:.2f} s) on {card}")
    return counts


def _forced_layers(torch, M, ops, ref, routes, params, cfg, x, caches, pos,
                   worst):
    """Every layer once on the kernel route and once on the plain route,
    both on the same input (the plain route's output of the layer before)
    and each into its own cache; records each layer's max |kernel - plain|
    over max |plain| in ``worst``.  Returns the last layer's two outputs.

    An attention block's attention half (what the kernel computes) is
    compared on its own too (a hybrid block's attention and Mamba paths
    fused, and its new Mamba state ``h`` and ``conv``).  In an MoE block the router picks each
    token's experts discretely and a capacity-full expert drops tokens,
    so a rounding difference that moves a token across a top-k boundary
    changes its whole MLP output: there the block's output is reported
    (``moe layer output``, with the tokens whose expert set changed) but
    not held to the tolerance; its attention half is."""
    from repro_torch.models import layers as L

    cache_k, cache_p = caches
    for l in range(cfg.num_layers):
        blk = M._block(params, l)
        pairs = []
        if cfg.block_kind == "rwkv6":
            xk, new_k = M._block_serve(blk, cfg, x,
                                       M._cache_layer(cache_k, l), pos)
            with plain_routes(ops, ref, *routes):
                xp, new_p = M._block_serve(blk, cfg, x,
                                           M._cache_layer(cache_p, l), pos)
            pairs += [(f"state {leaf}", new_k["state"][leaf],
                       new_p["state"][leaf]) for leaf in ("S", "x_tm", "x_cm")]
        else:
            hk, new_k = M._attn_serve(blk, cfg, x,
                                      M._cache_layer(cache_k, l), pos)
            with plain_routes(ops, ref, *routes):
                hp, new_p = M._attn_serve(blk, cfg, x,
                                          M._cache_layer(cache_p, l), pos)
            if "ssm" in new_k:
                pairs += [(f"mamba state {leaf}", new_k["ssm"][leaf],
                           new_p["ssm"][leaf]) for leaf in ("h", "conv")]
            mk = L.rmsnorm(blk["ln2"], hk, cfg.norm_eps)
            mp = L.rmsnorm(blk["ln2"], hp, cfg.norm_eps)
            xk = hk + M._mlp_apply(blk["mlp"], cfg, mk)[0]
            xp = hp + M._mlp_apply(blk["mlp"], cfg, mp)[0]
            pairs.append(("attention output", hk, hp))
            if cfg.moe:
                def experts(m):
                    logits = m.float() @ blk["mlp"]["router"]
                    return torch.topk(logits, cfg.top_k, dim=-1).indices.sort(
                        dim=-1).values
                moved = int((experts(mk) != experts(mp)).any(-1).sum())
                worst["tokens whose experts changed"] = max(
                    worst.get("tokens whose experts changed", 0), moved)
        M._store_layer(cache_k, l, new_k)
        M._store_layer(cache_p, l, new_p)
        pairs.append(("moe layer output" if cfg.moe else "layer output",
                      xk, xp))
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


def teacher_forced(torch, device, arch, cfg=None, profile=True):
    """Phase 8's kernel path against its plain path on member 0 (the CLI's
    seed), at the phase's request shape: a prefill and one decode step
    (of ``cfg``, when given, else ``arch``'s config; ``profile`` adds one
    profiled prefill and decode step).

    Teacher-forced, layer by layer (the gate): every layer gets the same
    input on both paths (the plain path's output of the layer before; for
    the decode step, the plain path's cache too), and its output, rwkv6's
    and Mamba's new state, and the logits of the last layer's two outputs must agree
    within bf16 tolerance (``LOGIT_REL_TOL`` x the plain side's max).
    Before it, one timed prefill and decode step on the kernel path alone,
    which must launch the path's kernels exactly: flash once a layer in
    the prefill, the WKV and selective-scan kernels once a layer in each
    of the two, and nothing else."""
    from repro_torch.configs import get_arch
    from repro_torch.core import population as pop
    from repro_torch.core.prng import fold_in
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import transformer as M

    cfg = get_arch(arch) if cfg is None else cfg
    routes = {"rwkv6": ("rwkv6_scan",),
              "hybrid": ("flash_attention", "selective_scan")}.get(
                  cfg.block_kind, ("flash_attention",))
    n_layers = cfg.num_layers
    expect = {"flash": 0 if cfg.block_kind == "rwkv6" else n_layers,
              "paged": 0,
              "wkv": 2 * n_layers if cfg.block_kind == "rwkv6" else 0,
              "ssm": 2 * n_layers if cfg.block_kind == "hybrid" else 0}
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
        log(f"{arch} (full width, {cfg.num_layers} layers, member 0, "
            f"B={SCAN_B}): prefill of {SCAN_S} "
            f"tokens {t_pre:.3f} s, one decode step {t_dec * 1e3:.1f} ms on the "
            f"kernel path (eager, host included; launches {counts}, "
            f"expected {expect})")
        if counts != expect:
            fail(f"{arch}: launches {counts} for a prefill and a step, "
                 f"expected {expect}")
        if profile:
            profile_serving(torch, params, cfg, tokens, cap, arch)

        worst = {}
        caches = (M.init_cache(cfg, SCAN_B, cap, device=device),
                  M.init_cache(cfg, SCAN_B, cap, device=device))
        x = M._embed_tokens(params, cfg, tokens)
        xk, xp = _forced_layers(torch, M, ops, ref, routes, params, cfg, x,
                                caches, None, worst)
        lg_k = M._logits(params, cfg, xk[:, -1:])
        lg_p = M._logits(params, cfg, xp[:, -1:])
        nxt = lg_p[:, -1].argmax(-1)
        for a, b in zip(pop.tree_leaves(caches[0]),
                        pop.tree_leaves(caches[1])):
            a.copy_(b)  # the decode step starts from the plain cache
        x = M._embed_tokens(params, cfg, nxt[:, None], pos0=SCAN_S)
        xk2, xp2 = _forced_layers(torch, M, ops, ref, routes, params, cfg,
                                  x, caches, SCAN_S, worst)
        worst["prefill logits"] = drift([lg_k], [lg_p])
        worst["decode-step logits"] = drift(
            [M._logits(params, cfg, xk2)], [M._logits(params, cfg, xp2)])
    log(f"teacher-forced {arch}, layer by layer ({cfg.num_layers} layers, "
        f"prefill and decode step): worst max |kernel - plain| / max |plain| "
        + ", ".join(f"{name} {v}" if isinstance(v, int) else
                    f"{name} {v:.4e}" for name, v in worst.items())
        + f" (tolerance {LOGIT_REL_TOL:g})")
    gated = {name: v for name, v in worst.items()
             if name not in ("moe layer output", "tokens whose experts changed")}
    bad = {name: v for name, v in gated.items() if not v <= LOGIT_REL_TOL}
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


# ---------------------------------------------------------------------------
# phase 10: the image-classification slice (classifier populations, soup
# against ensemble)
# ---------------------------------------------------------------------------

# ResNet-18's stage widths (64-512) on CIFAR's 32 x 32 x 3 geometry, one
# residual block a stage (the repo's resnet): 4.9 M float32 params a member
CNN_FULL = dict(width=64, depth=4, image_hw=32, num_classes=10)
CNN_N, CNN_BATCH, CNN_STEPS = 3, 128, 300   # members, images a member, steps
CNN_TIMED_STEPS = 30                        # the unchecked timing run
# the image task's default pixel noise (``make_image_task``): at the
# quickstart's 1.6, tuned for its MLP, a ResNet that pools globally stays
# near chance for hundreds of steps (the reference's as well)
CNN_NOISE = 0.35
CNN_P = 0.05                                # dense WASH base p, as the quickstart


def dense_planned_leaves(params, num_blocks: int, base_p: float) -> int:
    """Leaves of a member tree that a dense WASH plan covers: those whose
    layer gets p_l > 0 (decreasing schedule: the head gets none)."""
    from repro_torch.core import layer_index as tli
    from repro_torch.core.population import tree_leaves
    from repro_torch.core.schedules import layer_probability

    total = tli.total_layers(num_blocks)
    return sum(layer_probability(base_p, int(lid), total) > 0 for lid in
               tree_leaves(tli.infer_layer_ids(params, num_blocks)))


@contextlib.contextmanager
def tally_dense_masks(ops, tally):
    """Keep each dense shuffle's mask count, a leaf's each (a device
    tensor, read after the run); the shuffle runs as it would."""
    route = ops.wash_shuffle_many_

    def tallied(xs, perms, masks):
        tally.extend(mask.sum() for mask in masks)
        return route(xs, perms, masks)

    ops.wash_shuffle_many_ = tallied
    try:
        yield
    finally:
        ops.wash_shuffle_many_ = route


def cnn_quickstart(torch, device):
    """The quickstart (``launch.quickstart.main``) on the card, at its own
    configuration: its pattern must hold.  Returns its dense launches and
    the leaves they shuffled."""
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.launch import quickstart
    from repro_torch.models.cnn import ClassifierConfig, init_classifier

    cfg = ClassifierConfig(kind="mlp", width=64, depth=3, num_classes=10,
                           image_hw=12)
    planned = dense_planned_leaves(init_classifier(0, cfg, device),
                                   cfg.num_blocks, 0.05)
    torch.cuda.synchronize()
    ws.wash_launches = ws.bucketed_launches = ws.wash_leaves = 0
    t0 = time.perf_counter()
    rows = quickstart.main(["--device", str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, leaves = ws.wash_launches, ws.wash_leaves
    base, wash = {r["method"]: r for r in rows}.values()
    log(f"quickstart on the card (mlp 64 x 3, hw 12, N=4, 400 steps, batch "
        f"48, two populations): {wall:.2f} s; dense shuffle launches "
        f"{launches} (expected one a step, 400), leaves {leaves} (expected "
        f"{planned} planned leaves x 400 steps), bucketed "
        f"{ws.bucketed_launches}; WASH ensemble "
        f"{wash['ensemble']:.4f}, soup {wash['averaged']:.4f}, consensus "
        f"{wash['consensus']:.6g}; baseline ensemble {base['ensemble']:.4f}, "
        f"soup {base['averaged']:.4f} (the collapse: "
        f"{base['averaged'] - base['ensemble']:+.4f}), consensus "
        f"{base['consensus']:.6g}")
    if launches != 400 or leaves != planned * 400 or ws.bucketed_launches:
        fail(f"quickstart: {launches} dense launches of {leaves} leaves, "
             f"expected 400 of {planned * 400}")
    if not (wash["averaged"] >= wash["ensemble"] - 0.08
            and wash["ensemble"] > 0.5
            and wash["consensus"] < base["consensus"]):
        fail(f"quickstart: the pattern does not hold: {rows}")
    return launches, leaves


def _cnn_setup(torch, device, kind):
    """The full-width classifier of ``kind``, its image task (32 x 32,
    CNN_NOISE), heterogeneous member policies, ``data_fn``, ``loss_fn``
    and a 512-image eval set."""
    from repro_torch.core.prng import fold_in
    from repro_torch.data import (apply_policy, eval_images, make_image_task,
                                  member_policies, sample_images,
                                  soft_cross_entropy)
    from repro_torch.models.cnn import ClassifierConfig, apply_classifier

    cfg = ClassifierConfig(kind=kind, **CNN_FULL)
    seed = 19
    task = make_image_task(fold_in(seed, 1), cfg.num_classes, cfg.image_hw,
                           noise=CNN_NOISE, device=device)
    pols = member_policies(fold_in(seed, 7), CNN_N, True)

    def data_fn(m, step, s):
        images, labels = sample_images(task, s, CNN_BATCH)
        x, y = apply_policy(fold_in(s, 1), images, labels, cfg.num_classes,
                            pols[m])
        return {"x": x, "y": y}

    def loss_fn(params, batch):
        return soft_cross_entropy(apply_classifier(params, cfg, batch["x"]),
                                  batch["y"])

    return cfg, pols, data_fn, loss_fn, eval_images(task, fold_in(seed, 99),
                                                    512)


def _cnn_train(device, cfg, data_fn, loss_fn, mcfg, steps, optimizer="sgd",
               record_fn=None):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.cnn import init_classifier
    from repro_torch.train.loop import train_population

    tcfg = TrainConfig(population=CNN_N, optimizer=optimizer, lr=0.05,
                       total_steps=steps, batch_size=CNN_BATCH)
    return train_population(
        0, lambda s: init_classifier(s, cfg, device), loss_fn, data_fn, tcfg,
        mcfg, cfg.num_blocks, record_every=1 if record_fn else steps,
        record_fn=record_fn, device=device)


def cnn_evaluate(torch, cfg, population, ex, ey) -> dict:
    """Ensemble, uniform soup, greedy soup (and the members it kept), best
    and worst member accuracies on the eval set."""
    from repro_torch.core import averaging as avg
    from repro_torch.models.cnn import apply_classifier

    def apply_fn(p, x):
        return apply_classifier(p, cfg, x)

    with torch.no_grad():
        members = avg.member_accuracies(apply_fn, population, ex, ey).tolist()
        chosen = avg.greedy_soup_members(apply_fn, population, ex, ey)
        return {
            "ensemble": float(avg.ensemble_accuracy(apply_fn, population,
                                                    ex, ey)),
            "soup": float(avg.model_accuracy(
                apply_fn, avg.uniform_soup(population), ex, ey)),
            "greedy": float(avg.model_accuracy(
                apply_fn, avg.soup_of(population, chosen), ex, ey)),
            "greedy_members": chosen, "best": max(members),
            "worst": min(members)}


def cnn_full_width(torch, device):
    """The full-width ResNet population, dense WASH and baseline, CNN_STEPS
    steps: every shuffle through the dense kernel and bitwise equal to its
    plain version, one launch a step of all planned leaves (launches ==
    steps, leaves == planned leaves x steps), comm == the float64 count of
    the masks applied, finite losses; then the accuracies and the
    pattern.  Returns the run's dense launches and leaves."""
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.core.population import num_params
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.models.cnn import init_classifier

    cfg, pols, data_fn, loss_fn, (ex, ey) = _cnn_setup(torch, device,
                                                        "resnet")
    member = init_classifier(0, cfg, device)
    planned = dense_planned_leaves(member, cfg.num_blocks, CNN_P)
    n_params = num_params(member)
    del member
    steps, n = CNN_STEPS, CNN_N
    wash_cfg = MixingConfig(kind="wash", base_p=CNN_P, mode="dense")
    counts, tally = {"dense": 0, "bucketed": 0}, []
    torch.cuda.synchronize()
    ws.wash_launches = ws.bucketed_launches = ws.wash_leaves = 0
    t0 = time.perf_counter()
    with checked_shuffles(ops, ref, torch, counts), \
            tally_dense_masks(ops, tally):
        wash = _cnn_train(device, cfg, data_fn, loss_fn, wash_cfg, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, leaves = ws.wash_launches, ws.wash_leaves
    per_step = torch.stack(tally).view(steps, planned).sum(1).tolist() \
        if len(tally) == steps * planned else []
    applied = 0.0
    for sel in per_step:  # the loop's own sum: a float64 step at a time
        applied += float(sel) * (n - 1) / n
    log(f"resnet (stage widths {cfg.width}-{cfg.width * 2 ** (cfg.depth - 1)}"
        f" on {cfg.image_hw} x {cfg.image_hw} x 3, one residual block a "
        f"stage, {n_params} float32 params a member), N={n}, batch "
        f"{CNN_BATCH} a member, heterogeneous policies "
        f"{[dataclasses.astuple(p) for p in pols]} (mixup, smooth, cutmix, "
        f"erase), SGD lr 0.05, dense WASH p={CNN_P}, {steps} steps, every "
        f"shuffle held against its plain version: {wall:.2f} s; dense "
        f"launches {launches} (expected one a step, {steps}), leaves "
        f"{leaves} (expected {planned} planned leaves x {steps}), "
        f"{counts['dense']} bitwise equal to the plain version; comm of the "
        f"masks applied {applied!r}, recorded {wash.history['comm'][-1]!r}; "
        f"losses {wash.history['loss']}")
    if (launches != steps or leaves != planned * steps
            or counts["dense"] != leaves or ws.bucketed_launches):
        fail(f"resnet WASH: {launches} dense launches of {leaves} leaves "
             f"({counts['dense']} checked, {ws.bucketed_launches} bucketed), "
             f"expected {steps} of {planned * steps}")
    if applied != wash.history["comm"][-1] or applied <= 0:
        fail(f"resnet WASH: comm {wash.history['comm'][-1]} recorded, the "
             f"masks applied give {applied}")
    if not np.isfinite(wash.history["loss"]).all():
        fail(f"resnet WASH: losses {wash.history['loss']} are not finite")
    del tally
    ws.wash_launches = 0
    base = _cnn_train(device, cfg, data_fn, loss_fn, MixingConfig(kind="none"),
                      steps)
    if ws.wash_launches or ws.bucketed_launches:
        fail("resnet baseline: a shuffle ran without mixing")
    result = {}
    for name, res in (("WASH", wash), ("baseline", base)):
        acc = cnn_evaluate(torch, cfg, res.population, ex, ey)
        acc["consensus"] = res.history["consensus"][-1]
        result[name] = acc
        log(f"resnet {name}, {steps} steps, 512 eval images: ensemble "
            f"{acc['ensemble']:.4f}, uniform soup {acc['soup']:.4f} (soup - "
            f"ensemble {acc['soup'] - acc['ensemble']:+.4f}), greedy soup "
            f"{acc['greedy']:.4f} (members {acc['greedy_members']}), best "
            f"member {acc['best']:.4f}, worst {acc['worst']:.4f}; final "
            f"consensus distance {acc['consensus']:.6g}; last loss "
            f"{res.history['loss'][-1]:.4f}")
    del wash, base
    torch.cuda.empty_cache()
    chance = 1.0 / cfg.num_classes
    if result["WASH"]["ensemble"] <= 2 * chance:
        fail(f"resnet WASH did not learn: ensemble "
             f"{result['WASH']['ensemble']}")
    if result["WASH"]["consensus"] >= result["baseline"]["consensus"]:
        fail(f"resnet: WASH consensus {result['WASH']['consensus']} not "
             f"below the baseline's {result['baseline']['consensus']}")
    return launches, leaves


def cnn_vgg_bucketed(torch, device):
    """The full-width VGG, 3 steps of bucketed WASH+Opt under SGD momentum,
    on the kernels (every shuffle held bitwise) and on the plain versions,
    cuDNN deterministic: the final params within PARAM_TOL.  Returns the
    kernel run's bucketed launches."""
    from repro_torch.core import layer_index as tli
    from repro_torch.core import population as pop
    from repro_torch.core import shuffle as shf
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.models.cnn import init_classifier

    cfg, _, data_fn, loss_fn, _ = _cnn_setup(torch, device, "vgg")
    steps = REDUCED_STEPS
    mcfg = MixingConfig(kind="wash_opt", base_p=CNN_P, mode="bucketed")
    member = init_classifier(0, cfg, device)
    sizes = shf.bucketed_plan_sizes(
        member, tli.infer_layer_ids(member, cfg.num_blocks),
        tli.total_layers(cfg.num_blocks), CNN_P, "decreasing", CNN_N)
    planned = sum(k is not None for k in sizes)
    del member
    expected = planned * 2 * steps  # params and the momentum
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counts = {"dense": 0, "bucketed": 0}
        torch.cuda.synchronize()
        ws.wash_launches = ws.bucketed_launches = 0
        with checked_shuffles(ops, ref, torch, counts):
            res = _cnn_train(device, cfg, data_fn, loss_fn, mcfg, steps)
        torch.cuda.synchronize()
        launches = ws.bucketed_launches
        kept = pop.tree_map(torch.clone, res.population)
        losses = res.history["loss"]
        del res
        with plain_shuffles(ops, ref):
            plain = _cnn_train(device, cfg, data_fn, loss_fn, mcfg, steps)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = max(float((a - b).abs().max()) for a, b in zip(
        pop.tree_leaves(kept), pop.tree_leaves(plain.population)))
    log(f"vgg (widths {cfg.width}-{cfg.width * 2 ** (cfg.depth - 1)}, "
        f"{cfg.image_hw} x {cfg.image_hw}), N={CNN_N}, bucketed WASH+Opt "
        f"p={CNN_P}, SGD momentum, {steps} steps, cuDNN deterministic: "
        f"bucketed launches {launches} (expected {planned} planned leaves x 2 "
        f"x {steps}; plans (N, k_per) k_per {sizes}), {counts['bucketed']} "
        f"bitwise equal to the plain version, dense {ws.wash_launches}; max "
        f"|param kernel run - plain run| = {diff:.3e} (tolerance "
        f"{PARAM_TOL:g}); losses {losses} vs {plain.history['loss']}")
    if (launches != expected or counts["bucketed"] != launches
            or ws.wash_launches):
        fail(f"vgg WASH+Opt: {launches} bucketed launches ({counts} checked), "
             f"expected {expected}")
    if diff > PARAM_TOL or not np.isfinite(losses).all():
        fail(f"vgg WASH+Opt: kernel and plain runs differ by {diff}")
    del kept, plain
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def mixing_spans(torch):
    """``torch.profiler`` ranges around each mixing op (``wash.mix``), each
    plan draw (``wash.plan_draw``) and each grouped dense shuffle call
    (``wash.shuffle``), for one profiled step (observation only)."""
    from repro_torch.core import shuffle as shf
    from repro_torch.kernels import ops
    from repro_torch.train import loop

    saved = (loop.mix_once, shf.make_plan, ops.wash_shuffle_many_)

    def spanned(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    loop.mix_once = spanned("wash.mix", saved[0])
    shf.make_plan = spanned("wash.plan_draw", saved[1])
    ops.wash_shuffle_many_ = spanned("wash.shuffle", saved[2])
    try:
        yield
    finally:
        loop.mix_once, shf.make_plan, ops.wash_shuffle_many_ = saved


def cnn_timing(torch, device, card):
    """The full-width ResNet WASH run again, CNN_TIMED_STEPS steps without
    checks: the step split, images/s and peak memory; then one step
    profiled: device time by operator, and the plan draw's and the dense
    shuffle's shares of mixing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core.mixing import MixingConfig
    from repro_torch.models.cnn import init_classifier

    cfg, _, data_fn, loss_fn, _ = _cnn_setup(torch, device, "resnet")
    mcfg = MixingConfig(kind="wash", base_p=CNN_P, mode="dense")
    steps = CNN_TIMED_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = _cnn_train(device, cfg, data_fn, loss_fn, mcfg, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    images = CNN_N * CNN_BATCH * steps
    ph = {p: res.phase_ms[p][1:] for p in ("fwd_bwd", "opt", "mix")}
    mean = {p: sum(v) / len(v) for p, v in ph.items()}
    step_ms = sum(mean.values())
    log(f"resnet WASH step split on {card}, the same run without checks, "
        f"{steps} steps (CUDA events, ms a step, all {CNN_N} members, steps "
        f"2..): forward+backward {mean['fwd_bwd']:.3f} "
        f"({100 * mean['fwd_bwd'] / step_ms:.1f}%), optimizer "
        f"{mean['opt']:.3f} ({100 * mean['opt'] / step_ms:.1f}%), mixing "
        f"{mean['mix']:.3f} ({100 * mean['mix'] / step_ms:.1f}%); first step "
        f"{[round(res.phase_ms[p][0], 3) for p in ('fwd_bwd', 'opt', 'mix')]}"
        f"; {images} images in {wall:.2f} s = {images / wall:.1f} images/s "
        f"(population built and first step included); peak device memory "
        f"{peak:.3f} GiB")
    del res
    torch.cuda.empty_cache()

    from repro_torch.kernels import ops

    marks, masks = [], []
    route = ops.wash_shuffle_many_

    def tallied(xs, perms, ms):  # the profiled step's shuffles' shapes
        if len(marks) == 2:
            masks.extend((x.shape[0], x[0].numel(), x.element_size(),
                          mask.sum()) for x, mask in zip(xs, ms))
        return route(xs, perms, ms)

    ops.wash_shuffle_many_ = tallied
    try:
        with mixing_spans(torch), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=1, warmup=1, active=1)) as prof:
            def record(step, population):
                marks.append(time.perf_counter())
                prof.step()
                return {}

            _cnn_train(device, cfg, data_fn, loss_fn, mcfg, 3,
                       record_fn=record)
    finally:
        ops.wash_shuffle_many_ = route
    # the step's leaves in place (what the kernel must move), and out of
    # place (the bound before the redesign)
    shuffle_bytes = sum(shuffle_bytes_dense(n, d, elt, int(c), in_place=True)
                        for n, d, elt, c in masks)
    shuffle_bound, shuffle_by = bound(shuffle_bytes, 0, "f32")
    copy_bound = sum(shuffle_bytes_dense(n, d, elt, int(c))
                     for n, d, elt, c in masks) / HBM_BYTES_PER_S * 1e3
    wall_ms = (marks[2] - marks[1]) * 1e3
    busy_ms, spans, full, top = device_activity(prof)
    spans_ms = {a.key: (a.device_time_total / 1e3, a.cpu_time_total / 1e3)
                for a in prof.key_averages()
                if a.device_type == DeviceType.CPU and a.key.startswith("wash.")}
    if set(spans_ms) != {"wash.mix", "wash.plan_draw", "wash.shuffle"}:
        fail(f"profiled resnet step: mixing spans {sorted(spans_ms)}")
    # the shuffle kernel is launched through ctypes, outside any aten op,
    # so the profiler links its device time to no range: taken by name
    shuffle_us, launched = kernel_us(prof, ["wash_shuffle_kernel"])[
        "wash_shuffle_kernel"]
    planned = dense_planned_leaves(init_classifier(0, cfg, device),
                                   cfg.num_blocks, CNN_P)
    if launched != 1 or len(masks) != planned:
        fail(f"profiled resnet step: {launched} dense shuffle kernels seen "
             f"for {len(masks)} leaves, expected one for {planned} planned "
             f"leaves")
    mix_dev = spans_ms["wash.mix"][0] + shuffle_us / 1e3
    plan_dev = spans_ms["wash.plan_draw"][0]
    log(f"profiled resnet WASH step (full width, N={CNN_N}, under "
        f"torch.profiler): wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%, {spans} device "
        f"activities), idle {100 * (1 - busy_ms / wall_ms):.1f}%; the host "
        f"found the launch queue full {full} times; mixing: device "
        f"{mix_dev:.3f} ms, host {spans_ms['wash.mix'][1]:.3f} ms; the plan "
        f"draw device {plan_dev:.3f} ms ({100 * plan_dev / mix_dev:.1f}% of "
        f"mixing's device time), host {spans_ms['wash.plan_draw'][1]:.3f} ms;"
        f" the dense shuffle kernel {shuffle_us / 1e3:.4f} ms x{launched} "
        f"for {len(masks)} leaves (before the redesign "
        f"{DENSE_EARLIER_MS['resnet_step']:.3f} ms for 30 launches, proof "
        f"run 29; {100 * shuffle_us / 1e3 / mix_dev:.1f}% of mixing; bound "
        f"in place {shuffle_bound:.4f} ms by {shuffle_by}, {shuffle_bytes} "
        f"B; out of place {copy_bound:.4f} ms), its calls' host time "
        f"{spans_ms['wash.shuffle'][1]:.3f} ms; device time by operator: "
        f"{top}")


def image_classification(torch, device, kernels, card):
    """Phase 10.  Adds its launches to the two shuffle kernels' entries of
    the JSON line: the quickstart's and the ResNet's dense launches (and
    the leaves they shuffled), the VGG's bucketed ones."""
    t0 = time.perf_counter()
    quick = cnn_quickstart(torch, device)
    resnet = cnn_full_width(torch, device)
    dense, leaves = quick[0] + resnet[0], quick[1] + resnet[1]
    bucketed = cnn_vgg_bucketed(torch, device)
    cnn_timing(torch, device, card)
    kernels["dense"]["launches"] += dense
    kernels["dense"]["leaves"] = kernels["dense"].get("leaves", 0) + leaves
    kernels["bucketed"]["launches"] += bucketed
    log(f"phase 10 (image classification): {time.perf_counter() - t0:.1f} s; "
        f"dense launches {dense} of {leaves} leaves, bucketed {bucketed}")


# ---------------------------------------------------------------------------
# phase 11: serving under live traffic (the request driver, population
# speculative decoding, the whole-prompt admit, telemetry)
# ---------------------------------------------------------------------------

TRAFFIC_N, TRAFFIC_RATE = 16, 2.0     # requests, Poisson arrivals a second
# (24 requests before phase 19; fewer at the same rate make its room)
TRAFFIC_PREFIX = 512                  # tokens shared by every other prompt
TRAFFIC_S, TRAFFIC_NEW = (256, 2048), (16, 48)   # prompt, new-token ranges
SPEC_K = 4                            # full-width draft length
SPEC_REQS, SPEC_S, SPEC_NEW = 8, 512, 32
PHASE11_DIR = ROOT / "build" / "phase11"


def traffic_stream(B, cfg, n, seed):
    """``n`` requests with prompts of 256-2048 tokens and 16-48 new tokens
    drawn from ``seed``; every even-numbered prompt starts with one shared
    512-token prefix.  A smoke mix with no source, not a serving cell."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, TRAFFIC_PREFIX)
    reqs = []
    for i in range(n):
        S = int(rng.integers(TRAFFIC_S[0], TRAFFIC_S[1] + 1))
        new = int(rng.integers(TRAFFIC_NEW[0], TRAFFIC_NEW[1] + 1))
        prompt = rng.integers(0, cfg.vocab_size, S)
        if i % 2 == 0:
            S = max(S, TRAFFIC_PREFIX + 64)
            prompt = np.concatenate([prefix, rng.integers(
                0, cfg.vocab_size, S - TRAFFIC_PREFIX)])
        reqs.append(B.Request(i, prompt.astype(np.int32), new))
    return reqs


def fixed_stream(B, cfg, n, S, new, seed, uid=""):
    rng = np.random.default_rng(seed)
    return [B.Request(f"{uid}{i}" if uid else i,
                      rng.integers(0, cfg.vocab_size, S).astype(np.int32),
                      new) for i in range(n)]


def warm_up(B, cfg, server) -> None:
    """Two short requests (cuBLAS handles, the allocator), not measured;
    their uids are not the stream's, whose retirements the server reports
    by uid."""
    server.run(fixed_stream(B, cfg, 2, 32, 4, seed=99, uid="warm-up "))


def check_metrics(metrics, reqs, vocab, what):
    """Every request finished with its prompt kept, in-vocabulary tokens,
    a first token and per-token times."""
    for r in reqs:
        m = metrics.get(r.uid)
        if m is None or m.cancelled or m.tokens is None:
            fail(f"{what}: request {r.uid} did not finish")
        if m.tokens.shape != (len(r.tokens) + r.max_new,):
            fail(f"{what}: request {r.uid} has {m.tokens.shape} tokens")
        if (m.tokens[:len(r.tokens)] != r.tokens).any():
            fail(f"{what}: request {r.uid} lost its prompt")
        if m.tokens.min() < 0 or m.tokens.max() >= vocab:
            fail(f"{what}: request {r.uid} sampled out of the vocabulary")
        if m.first_token is None or len(m.token_times) != r.max_new:
            fail(f"{what}: request {r.uid} streamed {len(m.token_times)} "
                 f"of {r.max_new} tokens")


def slo_line(s) -> str:
    def ms(key):
        return "n/a" if s[key] is None else f"{s[key]:.1f} ms"
    return (f"{s['tokens_per_s']:.2f} tok/s, TTFT p50 {ms('ttft_p50_ms')} "
            f"p99 {ms('ttft_p99_ms')}, inter-token p99 "
            f"{ms('intertoken_p99_ms')}, latency p99 {ms('latency_p99_ms')}")


def driver_full_width(torch, device, soup, cfg, card):
    """The request driver over a soup server at full width, 24 requests
    at 2 a second, whole-prompt prefill then 256-token chunks.  Returns
    the paged kernel's launches."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import batching as B
    from repro_torch.serving.driver import (RequestDriver, poisson_arrivals,
                                            summarize)

    total = 0
    reqs = traffic_stream(B, cfg, TRAFFIC_N, seed=0)
    max_pages = -(-(TRAFFIC_S[1] + TRAFFIC_NEW[1]) // 16)
    for chunk in (None, 256):
        server = B.ContinuousServer(soup, cfg, mode="soup", max_slots=8,
                                    page_size=16, num_pages=2048,
                                    max_pages_per_slot=max_pages,
                                    retain_pages=True, device=device)
        warm_up(B, cfg, server)
        driver = RequestDriver(server, prefill_chunk=chunk)
        arrivals = poisson_arrivals(reqs, TRAFFIC_RATE, seed=0)
        steps0 = server.stats["decode_steps"]
        torch.cuda.synchronize()
        pa.launches = 0
        t0 = time.perf_counter()
        metrics = driver.run(arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pa.launches
        steps = server.stats["decode_steps"] - steps0
        what = f"driver (full width, prefill_chunk={chunk})"
        check_metrics(metrics, reqs, cfg.vocab_size, what)
        if driver.admitted_order != [r.uid for r in reqs]:
            fail(f"{what}: admission order {driver.admitted_order} is not "
                 "FIFO")
        if steps == 0 or launches != cfg.num_layers * steps:
            fail(f"{what}: {launches} paged launches for {steps} decode "
                 f"steps of {cfg.num_layers} layers")
        if server._pool.used_count:
            fail(f"{what}: {server._pool.used_count} pages still held")
        s = summarize(metrics)
        st = server.stats
        log(f"{what}: {TRAFFIC_N} requests at {TRAFFIC_RATE} req/s (Poisson, "
            f"seed 0), prompts {TRAFFIC_S[0]}-{TRAFFIC_S[1]} tokens (every "
            f"other on a {TRAFFIC_PREFIX}-token prefix), {TRAFFIC_NEW[0]}-"
            f"{TRAFFIC_NEW[1]} new; {slo_line(s)}; {s['generated_tokens']} "
            f"tokens, {wall:.2f} s wall; decode steps {steps}, paged launches "
            f"{launches} (expected {cfg.num_layers}x{steps}); prompt tokens "
            f"prefilled {st['prefill_tokens']} (prefix reused "
            f"{st['prefix_tokens_reused']}), FIFO admission; on {card}")
        log("driver summary " + json.dumps({"prefill_chunk": chunk, **s}))
        total += launches
        del server, driver
        torch.cuda.empty_cache()
    return total


def speculative_full_width(torch, device, popn, soup, cfg, card):
    """Ensemble with the soup drafting, then the soup drafting for itself,
    each beside its non-speculative server on the same stream.  Returns
    the paged kernel's launches."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import batching as B

    reqs = fixed_stream(B, cfg, SPEC_REQS, SPEC_S, SPEC_NEW, seed=11)
    geo = dict(max_slots=8, page_size=16, num_pages=320,
               max_pages_per_slot=-(-(SPEC_S + SPEC_NEW) // 16),
               device=device)
    total, rates = 0, {}
    for mode, members in (("ensemble", 2), ("soup", 1)):
        params = popn if mode == "ensemble" else soup
        for spec in (False, True):
            server = B.ContinuousServer(params, cfg, mode=mode,
                                        speculative=spec, draft_k=SPEC_K,
                                        **geo)
            warm_up(B, cfg, server)
            st0 = dict(server.stats)
            torch.cuda.synchronize()
            pa.launches = 0
            t0 = time.perf_counter()
            out = server.run(reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = pa.launches
            out = {r.uid: out[r.uid] for r in reqs if r.uid in out}
            steps = server.stats["decode_steps"] - st0["decode_steps"]
            what = (f"{mode} {'speculative k=' + str(SPEC_K) if spec else 'plain'}"
                    f" (full width)")
            check_results(out, reqs, cfg.vocab_size, what)
            per_step = (SPEC_K + members) if spec else members
            if steps == 0 or launches != cfg.num_layers * per_step * steps:
                fail(f"{what}: {launches} paged launches for {steps} decode "
                     f"steps, expected {cfg.num_layers}x{per_step}x{steps}")
            if server._pool.used_count:
                fail(f"{what}: {server._pool.used_count} pages still held")
            drafted = server.stats["spec_drafted"] - st0["spec_drafted"]
            accepted = server.stats["spec_accepted"] - st0["spec_accepted"]
            new = SPEC_REQS * SPEC_NEW
            rates[(mode, spec)] = new / dt
            ratio = f"{accepted / drafted:.4f}" if drafted else "n/a"
            log(f"{what}: {SPEC_REQS} requests of {SPEC_S} tokens, "
                f"{SPEC_NEW} new: {new / dt:.2f} tok/s ({dt:.3f} s); decode "
                f"calls {steps}, paged launches {launches} (expected "
                f"{cfg.num_layers}x{per_step}x{steps}); drafted {drafted}, "
                f"accepted {accepted}, accept ratio {ratio}; on {card}")
            total += launches
            del server
            torch.cuda.empty_cache()
    log(f"speculative at full width: ensemble {rates[('ensemble', True)]:.2f}"
        f" tok/s against {rates[('ensemble', False)]:.2f} plain; soup "
        f"drafting for itself {rates[('soup', True)]:.2f} against "
        f"{rates[('soup', False)]:.2f} (no ratio asserted at bf16)")
    return total


def whole_prompt_full_width(torch, device, soup, cfg):
    """A chunked-attention llama3.2-3b: admissions prefill the whole prompt
    through ``M.prefill`` (the flash kernel), decode through the paged
    kernel.  Returns (paged launches, flash launches)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import mixed_stream
    from repro_torch.serving import batching as B

    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    server = B.ContinuousServer(soup, chunked, mode="soup", max_slots=8,
                                page_size=16, num_pages=320,
                                max_pages_per_slot=-(-(512 + 32) // 16),
                                device=device)
    if server.suffix_prefill:
        fail("a chunked-attention config took the suffix-prefill path")
    reqs = mixed_stream(chunked, 8, 512, 32, seed=5, share_prefix_every=4)
    admitted0 = server.stats["admitted"]
    fa.launches = 0
    _, paged = serve_stream(torch, pa, server, reqs,
                            "whole-prompt admit (full width, attn chunked)",
                            cfg.num_layers)
    flash = fa.launches
    admitted = server.stats["admitted"] - admitted0
    log(f"whole-prompt admit: {admitted} admissions, flash launches {flash} "
        f"(expected {admitted}x{cfg.num_layers}), pages shared "
        f"{server.stats['pages_shared']}")
    if flash != admitted * cfg.num_layers:
        fail(f"whole-prompt admit: {flash} flash launches for {admitted} "
             f"admissions")
    del server
    torch.cuda.empty_cache()
    return paged, flash


@contextlib.contextmanager
def held_against_plain(torch, ops, ref, name, tol, note, seen):
    """Let ``ops.<name>`` launch its kernel as the path does, and hold
    each call's output against the plain version on the same inputs,
    before the pools change again; the phase fails past ``tol``.
    ``note(args)`` describes a call's inputs, and ``seen`` collects
    ``(note with the plain output's max |value|, error)`` per call."""
    kernel, plain = getattr(ops, name), getattr(ref, f"{name}_ref")

    def checked(*args, **kw):
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        if not torch.isfinite(got.float()).all():
            fail(f"{name} at {note(args)}: kernel output is not finite")
        err = float((got.float() - want.float()).abs().max())
        where = {**note(args), "max_plain": float(want.float().abs().max())}
        if err > tol:
            fail(f"{name} at {where} disagrees with its plain version: "
                 f"{err} > {tol}")
        seen.append((where, err))
        return got

    setattr(ops, name, checked)
    try:
        yield
    finally:
        setattr(ops, name, kernel)


LONG_S, LONG_NEW = (1990, 2040), (2, 9)  # the verify check's prompts, budgets


def kernels_at_traffic_shapes(torch, device, popn, soup, cfg):
    """The kernels at the shapes this phase gives them, full width in
    bf16, each call held against its plain version on untimed runs whose
    launches do not count: the speculative verify (8 slots x k rows
    through ``repeat_interleave``d tables; rows past a budget and an empty
    slot's rows pointed at scratch page 0) and the draft steps at
    contexts near 2048; then the whole-prompt admit's flash prefill and
    its decode at the traffic stream's shortest and longest prompts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import batching as B

    n0 = (pa.launches, fa.launches)

    def paged_note(args):
        q, table, lengths = args[0], args[3], args[4]
        return {"rows": q.shape[0], "max_len": int(lengths.max()),
                "scratch_rows": int((table == 0).all(dim=1).sum())}

    def flash_note(args):
        return {"S": args[0].shape[1]}

    # 7 requests on 8 slots, budgets 2..8 new tokens against k = 4
    rng = np.random.default_rng(31)
    reqs = [B.Request(i, rng.integers(0, cfg.vocab_size, int(rng.integers(
        LONG_S[0], LONG_S[1] + 1))).astype(np.int32), new)
        for i, new in enumerate(range(*LONG_NEW))]
    max_pages = -(-(LONG_S[1] + LONG_NEW[1] + SPEC_K) // 16)
    server = B.ContinuousServer(popn, cfg, mode="ensemble", speculative=True,
                                draft_k=SPEC_K, max_slots=8, page_size=16,
                                num_pages=8 * max_pages + 8,
                                max_pages_per_slot=max_pages, device=device)
    seen = []
    tol = KERNEL_TOL["bf16"]
    with held_against_plain(torch, ops, ref, "paged_attention", tol,
                            paged_note, seen):
        check_results(server.run(reqs), reqs, cfg.vocab_size,
                      "speculative verify check")
    verify = [(n, e) for n, e in seen if n["rows"] == 8 * SPEC_K]
    draft = [(n, e) for n, e in seen if n["rows"] == 8]
    mixed = [n for n, _ in verify if 0 < n["scratch_rows"] < n["rows"]]
    longest = max(n["max_len"] for n, _ in verify) if verify else 0
    scratch = max((n["scratch_rows"] for n in mixed), default=0)
    log(f"paged bf16 at the speculative shapes (ensemble of 2, k={SPEC_K}, "
        f"8 slots, prompts {LONG_S[0]}-{LONG_S[1]}): {len(verify)} verify "
        f"calls of {8 * SPEC_K} rows (up to {scratch} on scratch page 0; "
        f"contexts up to {longest}), max |kernel - "
        f"plain| = {max((e for _, e in verify), default=float('nan')):.3e}; "
        f"{len(draft)} draft calls of 8 rows, max |kernel - plain| = "
        f"{max((e for _, e in draft), default=float('nan')):.3e} "
        f"(tolerance {tol:g}; outputs up to "
        f"{max((n['max_plain'] for n, _ in seen), default=0):.3g})")
    if not mixed or longest < LONG_S[0] or not draft:
        fail(f"speculative verify check: {len(verify)} verify calls, "
             f"{len(mixed)} with scratch rows, contexts up to {longest}, "
             f"{len(draft)} draft calls")
    del server
    torch.cuda.empty_cache()

    # the whole-prompt admit at the traffic's shortest and longest prompts
    traffic = traffic_stream(B, cfg, TRAFFIC_N, seed=0)
    lens = [len(r.tokens) for r in traffic]
    reqs = [B.Request(i, traffic[lens.index(f(lens))].tokens, 4)
            for i, f in enumerate((min, max))]
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    max_pages = -(-(max(lens) + 4) // 16)
    server = B.ContinuousServer(soup, chunked, mode="soup", max_slots=2,
                                page_size=16, num_pages=2 * max_pages + 2,
                                max_pages_per_slot=max_pages, device=device)
    flash, paged = [], []
    with held_against_plain(torch, ops, ref, "flash_attention",
                            FLASH_TOL["bf16"], flash_note, flash), \
            held_against_plain(torch, ops, ref, "paged_attention", tol,
                               paged_note, paged):
        check_results(server.run(reqs), reqs, cfg.vocab_size,
                      "whole-prompt admit check")
    sizes = sorted({n["S"] for n, _ in flash})
    log(f"flash bf16 in the whole-prompt admit at prompts {sizes}: "
        f"{len(flash)} calls, max |kernel - plain| = "
        f"{max(e for _, e in flash):.3e} (tolerance {FLASH_TOL['bf16']:g}; "
        f"outputs up to {max(n['max_plain'] for n, _ in flash):.3g}); its "
        f"decode: {len(paged)} paged calls, max |kernel - plain| = "
        f"{max(e for _, e in paged):.3e}")
    if sizes != sorted({min(lens), max(lens)}) or not paged:
        fail(f"whole-prompt admit check: flash ran at {sizes}, {len(paged)} "
             "paged calls")
    del server
    torch.cuda.empty_cache()
    pa.launches, fa.launches = n0  # comparison launches do not count


def logit_margin(torch, M, averaging, members, cfg, tokens) -> float:
    """The top-2 margin of the (member-averaged) next-token logits after
    ``tokens``, on the plain path: how close a differing token was."""
    batch = {"tokens": torch.as_tensor(tokens[None]).to(
        members[0]["embed"]["tok"].device)}
    lgs = torch.stack([M.prefill(p, cfg, batch)[0][0, -1] for p in members])
    top = averaging.balanced_mean(lgs).float().topk(2).values
    return float(top[0] - top[1])


def same_tokens(torch, got, want, reqs, what, margin_of=None):
    """Per request, the tokens must be identical; on a difference, the
    first differing position and the plain logits' top-2 margin there are
    reported before the phase fails."""
    for r in reqs:
        a, b = np.asarray(got[r.uid]), np.asarray(want[r.uid])
        if a.shape != b.shape or (a != b).any():
            pos = (int(np.argmax(a != b)) if a.shape == b.shape
                   else min(len(a), len(b)))
            margin = (margin_of(b[:pos]) if margin_of is not None
                      and pos > 0 else float("nan"))
            fail(f"{what}: request {r.uid} differs at token {pos} (the "
                 f"reference's logits' top-2 margin there {margin:.3e})")


def reduced_traffic(torch, device):
    """Reduced float32 on the card (TF32 off): the driver against
    ``server.run`` on the plain path; speculative (k in 1, 3, 8, soup and
    ensemble, greedy and temperature 0.8) against plain decode, both on
    the kernels, and plain decode on the kernels against the plain path;
    the whole-prompt admit on the kernels against the plain path; int8
    speculative against int8 plain.  Returns the kernels' launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import averaging
    from repro_torch.core import population as pop
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import init_population, mixed_stream
    from repro_torch.models import transformer as M
    from repro_torch.serving import batching as B
    from repro_torch.serving.driver import RequestDriver

    cfg = get_arch("llama3.2-3b").reduced()
    popn = init_population(cfg, 2, seed=21, device=device)
    soup = B.serving_params(popn, "soup")
    geo = dict(page_size=8, max_slots=4, num_pages=192, device=device)
    counts = {"f32": 0, "int8": 0, "flash_f32": 0}

    def tokens(out):
        return {u: r.tokens for u, r in out.items()}

    def serve(params, mode, reqs, temperature=0.0, **kw):
        server = B.ContinuousServer(params, cfg, mode=mode,
                                    temperature=temperature, **geo, **kw)
        return tokens(server.run(reqs)), server

    def margin_for(params, mode):
        members = ([pop.member(params, i) for i in range(2)]
                   if mode == "ensemble" else [params])
        return lambda toks: logit_margin(torch, M, averaging, members, cfg,
                                         toks)

    # the driver (chunked prefill, interleaved) against server.run
    reqs = mixed_stream(cfg, 12, 48, 12, seed=23, share_prefix_every=3)
    server = B.ContinuousServer(soup, cfg, retain_pages=True, **geo)
    pa.launches = 0
    driver = RequestDriver(server, prefill_chunk=16)
    for r in reqs:
        driver.submit(r)
    metrics = driver.drain()
    counts["f32"] += pa.launches
    with plain_routes(ops, ref, "paged_attention"):
        want, _ = serve(soup, "soup", reqs)
    same_tokens(torch, {u: m.tokens for u, m in metrics.items()}, want, reqs,
                "reduced f32 driver (kernels) against server.run (plain)",
                margin_for(soup, "soup"))
    log(f"reduced f32: the driver's tokens (prefill chunk 16, kernels) == "
        f"server.run's (plain path) for {len(reqs)} requests")

    # speculative against plain
    results = []
    for mode in ("soup", "ensemble"):
        params = popn if mode == "ensemble" else soup
        for temperature in (0.0, 0.8):
            reqs = [B.Request(r.uid, r.tokens, r.max_new, seed=500 + r.uid)
                    for r in mixed_stream(cfg, 8, 40, 10, seed=24)]
            pa.launches = 0
            plain_k, _ = serve(params, mode, reqs, temperature)
            counts["f32"] += pa.launches
            with plain_routes(ops, ref, "paged_attention"):
                plain_p, _ = serve(params, mode, reqs, temperature)
            what = f"reduced f32 {mode} T={temperature}"
            same_tokens(torch, plain_k, plain_p, reqs,
                        f"{what}: plain decode, kernels against plain path",
                        margin_for(params, mode))
            for k in (1, 3, 8):
                pa.launches = 0
                spec, server = serve(params, mode, reqs, temperature,
                                     speculative=True, draft_k=k)
                counts["f32"] += pa.launches
                same_tokens(torch, spec, plain_k, reqs,
                            f"{what} speculative k={k} against plain decode",
                            margin_for(params, mode))
                st = server.stats
                results.append(f"{mode} T={temperature} k={k}: accepted "
                               f"{st['spec_accepted']}/{st['spec_drafted']}")
    log("reduced f32 speculative == plain decode, tokens identical per "
        "request, on the kernels: " + "; ".join(results))

    # the whole-prompt admit: flash f32 and paged kernels against plain
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    reqs = mixed_stream(chunked, 8, 48, 10, seed=25, share_prefix_every=3)
    for mode in ("soup", "ensemble"):
        params = popn if mode == "ensemble" else soup
        pa.launches = fa.launches = 0
        server = B.ContinuousServer(params, chunked, mode=mode, **geo)
        got = tokens(server.run(reqs))
        counts["f32"] += pa.launches
        counts["flash_f32"] += fa.launches
        expect = server.stats["admitted"] * cfg.num_layers * (
            2 if mode == "ensemble" else 1)
        if fa.launches != expect:
            fail(f"reduced whole-prompt admit {mode}: {fa.launches} flash "
                 f"launches, expected {expect}")
        with plain_routes(ops, ref, "paged_attention", "flash_attention"):
            want = tokens(B.ContinuousServer(params, chunked, mode=mode,
                                             **geo).run(reqs))
        same_tokens(torch, got, want, reqs,
                    f"reduced f32 whole-prompt admit {mode}, kernels "
                    "against plain")
    log("reduced f32 whole-prompt admit (attn chunked): tokens on the flash "
        "and paged kernels == plain path, soup and ensemble")

    # int8 speculative against int8 plain, on the kernels
    reqs = mixed_stream(cfg, 8, 40, 10, seed=26)
    pa.launches = 0
    plain8, _ = serve(soup, "soup", reqs, kv_dtype="int8")
    spec8, server = serve(soup, "soup", reqs, kv_dtype="int8",
                          speculative=True, draft_k=4)
    counts["int8"] += pa.launches
    same_tokens(torch, spec8, plain8, reqs,
                "reduced int8 speculative k=4 against int8 plain")
    log(f"reduced int8 KV: speculative k=4 tokens == plain int8 tokens "
        f"(accepted {server.stats['spec_accepted']}/"
        f"{server.stats['spec_drafted']}); {counts['int8']} launches with "
        f"f32 queries on int8 pools")
    del popn, soup
    torch.cuda.empty_cache()
    return counts


def run_schema_check(path, *flags) -> None:
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "check_metrics_schema.py"),
                          *flags, str(path)], capture_output=True,
                         text=True, timeout=120)
    log(f"schema check {' '.join(flags)} {path.name}: "
        f"{(out.stdout + out.stderr).strip()}")
    if out.returncode != 0:
        fail(f"{path}: the telemetry stream fails the schema check")


def traffic_clis(torch, device):
    """The serve CLI with the driver, speculative decoding and telemetry
    at full width; the train CLI with telemetry at the reduced size; both
    streams through ``tools/check_metrics_schema.py``; a profile window's
    Chrome trace.  Returns the paged kernel's bf16 launches."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    PHASE11_DIR.mkdir(parents=True, exist_ok=True)
    serve_out = PHASE11_DIR / "serve.jsonl"
    train_out = PHASE11_DIR / "train.jsonl"
    prof_dir = PHASE11_DIR / "profile"
    for p in (serve_out, train_out, prof_dir / "trace.json"):
        if p.exists():
            p.unlink()
    torch.cuda.synchronize()
    pa.launches = 0
    _, s = serve_cli.main([
        "--arch", "llama3.2-3b", "--population", "2", "--continuous",
        "--driver", "--arrival-rate", "2", "--prefill-chunk", "256",
        "--retain-pages", "--speculative", "--requests", "8", "--seq-len",
        "512", "--max-new", "32", "--max-slots", "8", "--num-pages", "400",
        "--metrics-out", str(serve_out)])
    torch.cuda.synchronize()
    launches = pa.launches
    log(f"serve CLI (full width, --driver --speculative, 8 requests at 2/s): "
        f"{slo_line(s)}; paged launches {launches}")
    if s["requests"] != 8 or launches == 0:
        fail(f"serve CLI: {s['requests']} requests, {launches} launches")
    torch.cuda.empty_cache()
    train_cli.main(["--arch", "llama3.2-3b", "--reduced", "--population",
                    "2", "--mode", "bucketed", "--steps", "4",
                    "--batch-size", "2", "--seq-len", "16", "--metrics-out",
                    str(train_out)])
    run_schema_check(serve_out)
    run_schema_check(train_out, "--require-comm")
    serve_cli.main(["--arch", "llama3.2-3b", "--reduced", "--population",
                    "2", "--continuous", "--requests", "6", "--max-new",
                    "8", "--seq-len", "32", "--profile-dir", str(prof_dir)])
    trace = prof_dir / "trace.json"
    if not trace.exists():
        fail("--profile-dir wrote no trace")
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
    log(f"--profile-dir: {trace.stat().st_size} B Chrome trace, "
        f"{len(events)} events, {kernels} device kernels")
    if not kernels:
        fail("the profile trace holds no device kernel")
    return launches


def live_traffic(torch, device, kernels, card):
    """Phase 11.  Adds its launches to the paged (bf16, f32, f32 queries on
    int8 pools) and flash (bf16, f32) entries of the JSON line."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import init_population
    from repro_torch.serving.engine import averaged_params

    t0 = time.perf_counter()
    cfg = get_arch("llama3.2-3b")
    popn = init_population(cfg, 2, seed=0, device=device)
    soup = averaged_params(popn)
    bf16 = driver_full_width(torch, device, soup, cfg, card)
    bf16 += speculative_full_width(torch, device, popn, soup, cfg, card)
    paged, flash = whole_prompt_full_width(torch, device, soup, cfg)
    bf16 += paged
    kernels_at_traffic_shapes(torch, device, popn, soup, cfg)
    del popn, soup
    torch.cuda.empty_cache()
    reduced = reduced_traffic(torch, device)
    bf16 += traffic_clis(torch, device)
    kernels["bf16"]["launches"] += bf16
    kernels["flash_bf16"]["launches"] += flash
    kernels["f32"]["launches"] += reduced["f32"]
    kernels["f32-int8"]["launches"] += reduced["int8"]
    kernels["flash_f32"]["launches"] += reduced["flash_f32"]
    log(f"phase 11 (serving under live traffic): "
        f"{time.perf_counter() - t0:.1f} s; paged bf16 launches {bf16}, "
        f"flash bf16 {flash}, paged f32 {reduced['f32']}, paged f32 on int8 "
        f"pools {reduced['int8']}, flash f32 {reduced['flash_f32']}")


# ---------------------------------------------------------------------------
# phase 12: MoE and MLA (DeepSeek-V2-Lite at full width, kimi-k2 reduced),
# and the dense configs
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek-v2-lite-16b"
KIMI = "kimi-k2-1t-a32b"
# DeepSeek-V2-Lite's prefill attention: B, S, H, KV, q/k width, v width
MLA_SHAPE = (4, 2048, 16, 16, 192, 128)
# the reduced DeepSeek at the full model's MLA widths (its own reduced
# widths, 32 + 16 and 32, have no flash instantiation)
MLA_WIDTHS = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)
DENSE_ARCHS = ("qwen3-4b", "qwen1.5-4b", "minitron-8b")
DENSE_LAYERS = 2  # depth of their full-width teacher-forced runs
CARD_BYTES = 80e9


def library_backend(torch, F, q, k, v):
    """The first fused SDPA backend that takes these (B, H, S, d) inputs,
    v narrower than q and k, or None (the math backend is not counted)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    return None


def check_flash_mla(torch, fa, ref, F, device):
    """Phase 12, the kernel alone: the (192, 128) instantiation against its
    plain version at DeepSeek-V2-Lite's prefill shape, bf16 and f32,
    causal, and a ragged non-causal S=1000; then timed beside its bound,
    its plain version and the first fused SDPA backend that takes v
    narrower than q/k.  Returns the JSON line's entries (launches filled
    in by the main path)."""
    B, S, H, KV, hd, hv = MLA_SHAPE
    errs = {}
    for n, (dt, s, causal) in enumerate([("bf16", S, True), ("f32", S, True),
                                         ("bf16", 1000, False),
                                         ("f32", 1000, False)]):
        q, k, v = flash_inputs(torch, B, s, H, KV, hd, dt, device, 120 + n,
                               hv=hv)
        got = fa.flash_attention_cuda(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if got.shape != (B, s, H, hv) or not torch.isfinite(got.float()).all():
            fail(f"flash {dt} {hd}x{hv} S={s}: output {tuple(got.shape)} "
                 "not finite or of the wrong shape")
        err = float((got.float() - want.float()).abs().max())
        what = (f"flash attention {dt} ({hd}, {hv}) B={B} S={s} H={H} KV={KV} "
                f"{'causal' if causal else 'non-causal'}")
        log(f"{what}: max |kernel - plain| = {err:.3e} (tolerance "
            f"{FLASH_TOL[dt]:g})")
        if err > FLASH_TOL[dt]:
            fail(f"{what} disagrees with its plain version: {err}")
        if s == S:
            errs[dt] = err
        del q, k, v, got, want
    torch.cuda.empty_cache()

    from torch.nn.attention import sdpa_kernel

    entries = {}
    for dt in ("bf16", "f32"):
        sets = [flash_inputs(torch, B, S, H, KV, hd, dt, device, 130 + i,
                             hv=hv) for i in range(2)]
        lib = [tuple(x.transpose(1, 2).contiguous() for x in xs)
               for xs in sets]
        n0 = fa.launches
        ms = device_ms(torch, lambda i: fa.flash_attention_cuda(*sets[i]), 2)
        plain_ms = device_ms(torch,
                             lambda i: ref.flash_attention_ref(*sets[i]), 2,
                             reps=5)
        backend = library_backend(torch, F, *lib[0])
        library_ms = None
        if backend is not None:
            def sdpa(i):
                with sdpa_kernel([backend]):
                    return F.scaled_dot_product_attention(*lib[i],
                                                          is_causal=True)
            library_ms = device_ms(torch, sdpa, 2)
        fa.launches = n0  # comparison launches do not count
        nbytes, ops = flash_work(B, S, H, KV, hd, dt, True, hv=hv)
        bound_ms, bound_by = bound(nbytes, ops, dt)
        rate = ops / (ms * 1e-3)
        lib_text = ("none (no fused SDPA backend takes v narrower than q/k "
                    f"in {dt})" if backend is None else
                    f"{library_ms:.4f} ms ({backend.name})")
        log(f"flash attention {dt} causal ({hd}, {hv}) at the "
            f"DeepSeek-V2-Lite prefill shape: {ms:.4f} ms on the device, "
            f"plain {plain_ms:.4f} ms, library (SDPA) {lib_text}, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {ops} ops); "
            f"achieved {rate / 1e12:.2f} TFLOP/s, "
            f"{rate / PEAK_OPS[dt]:.1%} of the {dt} rate; "
            f"{attributes_line(fa.kernel_attributes(sets[0][0].dtype, hd, hv))}")
        entries[f"flash_{dt}_mla"] = {
            "name": f"flash_attention[{dt},causal,{hd}x{hv}]",
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
    return entries


def serve_deepseek(torch, device, card):
    """The serve CLI's scan engine (``--compare``: member, ensemble, then
    the soup made in place from the population's memory) on a random N=2
    full-width DeepSeek-V2-Lite (bf16) from seed 0, B=4 prompts of 2048
    tokens, 32 new.  Every prefill attention goes through the (192, 128)
    flash kernel: launches == 2 requests x 27 layers x 4 member-runs.
    Returns the launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core.prng import fold_in
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.core.population import tree_leaves
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import transformer as M

    cfg = get_arch(DEEPSEEK)
    expect = {"flash": REQUESTS_PER_MODE * cfg.num_layers
              * sum(MODE_MEMBERS.values()), "paged": 0, "wkv": 0, "ssm": 0}
    one_model = sum(x.numel() * x.element_size()
                    for x in tree_leaves(M.param_shapes(cfg)))
    floor_ms = one_model / HBM_BYTES_PER_S * 1e3
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(fa, wkv, pa)
    t0 = time.perf_counter()
    outs = serve_cli.main(["--arch", DEEPSEEK, "--population", "2", "--seed",
                           "0", "--batch-size", str(SCAN_B), "--seq-len",
                           str(SCAN_S), "--max-new", str(SCAN_NEW),
                           "--compare"])
    torch.cuda.synchronize()
    counts = _counts(fa, wkv, pa)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"scan engine {DEEPSEEK} (full width, {cfg.num_layers} layers, bf16, "
        f"N=2 = {2 * one_model / 2**30:.2f} GiB of weights, B={SCAN_B}, "
        f"S={SCAN_S}, max_new {SCAN_NEW}; member, ensemble, then the soup "
        f"in place, each twice): {dt:.2f} s with the population's init; "
        f"kernel launches {counts} (expected {expect}); peak allocated "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB of the card's 80)")
    if counts != expect:
        fail(f"{DEEPSEEK}: kernel launches {counts}, expected {expect}")
    if peak >= CARD_BYTES:
        fail(f"{DEEPSEEK}: peak allocated {peak} B")
    if list(outs) != ["member", "ensemble", "soup"]:
        fail(f"{DEEPSEEK}: served modes {list(outs)}")
    prompts = concrete_batch(cfg, fold_in(0, 2), SCAN_B, SCAN_S,
                             device=device)["tokens"]
    for mode, res in outs.items():
        toks = res["tokens"]
        if toks.shape != (SCAN_B, SCAN_S + SCAN_NEW):
            fail(f"{DEEPSEEK} {mode}: tokens of shape {tuple(toks.shape)}")
        if not torch.equal(toks[:, :SCAN_S].long(), prompts.long()):
            fail(f"{DEEPSEEK} {mode}: the prompt was not kept")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            fail(f"{DEEPSEEK} {mode}: sampled out of the vocabulary")
        floor = floor_ms * MODE_MEMBERS[mode]
        log(f"scan engine {DEEPSEEK} {mode}: {res['tok_s']:.2f} tok/s (B="
            f"{SCAN_B} x {SCAN_NEW} new tokens in {res['steady_s']:.3f} s); "
            f"prefill {res['prefill_s']:.3f} s, decode step "
            f"{res['decode_step_ms']:.2f} ms (floor {floor:.2f} ms: "
            f"{MODE_MEMBERS[mode]} x {one_model / 2**30:.2f} GiB read at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, every expert a step); first "
            f"request {res['first_s']:.2f} s; on {card}")
    return counts["flash"]


def moe_reduced_f32(torch, device):
    """Reduced float32 on the card (TF32 off), kernels against the plain
    path, greedy tokens identical: DeepSeek at the full model's MLA widths
    through the scan engine (soup and ensemble; flash launches == layers
    x members), kimi-k2 through ``ContinuousServer`` (soup and ensemble;
    paged launches == layers x members x decode steps).  The reduced
    DeepSeek at its own MLA widths is refused on the card.  Returns the
    launches: ``{"flash_f32_mla": n, "f32": n}``."""
    from repro_torch.configs import get_arch
    from repro_torch.core import averaging
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch.serve import init_population, mixed_stream
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.serving import batching as B
    from repro_torch.serving import engine

    launches = {"flash_f32_mla": 0, "f32": 0}
    cfg = get_arch(DEEPSEEK).reduced(**MLA_WIDTHS)
    popn = init_population(cfg, 2, seed=5, device=device)
    batch = concrete_batch(cfg, 9, 4, 64, device=device)
    for mode in ("soup", "ensemble"):
        params = engine.serving_params(popn, mode)
        torch.cuda.synchronize()
        _zero(fa, wkv, pa)
        out_k = engine.generate(params, cfg, batch, 16, mode=mode,
                                device=device)
        torch.cuda.synchronize()
        n = fa.launches
        with plain_routes(ops, ref, "flash_attention"):
            out_p = engine.generate(params, cfg, batch, 16, mode=mode,
                                    device=device)
        expect = cfg.num_layers * MODE_MEMBERS[mode]
        same = torch.equal(out_k, out_p)
        log(f"reduced f32 {DEEPSEEK} at MLA widths (192, 128) {mode} (B=4, "
            f"S=64, 16 new): greedy tokens kernel path == plain path: "
            f"{same}; flash launches {n} (expected {expect})")
        if not same:
            fail(f"reduced f32 {DEEPSEEK} {mode}: greedy tokens differ")
        if n != expect:
            fail(f"reduced f32 {DEEPSEEK} {mode}: {n} flash launches")
        launches["flash_f32_mla"] += n
    own = get_arch(DEEPSEEK).reduced()
    refused(f"engine.generate of the reduced {DEEPSEEK} at its own MLA "
            f"widths {own.qk_nope_dim + own.qk_rope_dim, own.v_head_dim}",
            lambda: engine.generate(params, own, batch, 4, device=device),
            str(fa.HEAD_DIMS))
    del popn, params

    cfg = get_arch(KIMI).reduced()
    popn = init_population(cfg, 2, seed=6, device=device)
    soup = averaging.uniform_soup(popn)
    geo = dict(page_size=8, max_slots=4, num_pages=128, device=device)
    reqs = mixed_stream(cfg, 8, 48, 12, seed=7)
    for mode, params in (("soup", soup), ("ensemble", popn)):
        what = f"reduced f32 {KIMI} {mode} (MoE, GQA), kernel path"
        out_k, n = serve_stream(
            torch, pa, B.ContinuousServer(params, cfg, mode=mode, **geo),
            reqs, what, cfg.num_layers, MODE_MEMBERS[mode])
        with plain_routes(ops, ref, "paged_attention"):
            out_p = B.ContinuousServer(params, cfg, mode=mode, **geo).run(reqs)
        same_tokens(torch, {u: r.tokens for u, r in out_k.items()},
                    {u: r.tokens for u, r in out_p.items()}, reqs,
                    f"reduced f32 {KIMI} {mode}: kernels against plain")
        log(f"reduced f32 {KIMI} {mode}: greedy tokens kernel path == plain "
            f"path for {len(reqs)} requests")
        launches["f32"] += n
    del popn, soup
    torch.cuda.empty_cache()
    return launches


def moe_and_mla(torch, device, kernels, card):
    """Phase 12 after ``check_flash_mla``: full-width DeepSeek-V2-Lite
    through the serve CLI, its teacher-forced prefill and decode step,
    the reduced f32 MoE runs, and each dense config's full-width
    2-layer teacher-forced prefill and decode step."""
    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    kernels["flash_bf16_mla"]["launches"] += serve_deepseek(torch, device,
                                                            card)
    teacher_forced(torch, device, DEEPSEEK)
    reduced = moe_reduced_f32(torch, device)
    kernels["flash_f32_mla"]["launches"] += reduced["flash_f32_mla"]
    kernels["f32"]["launches"] += reduced["f32"]
    for arch in DENSE_ARCHS:
        cfg = dataclasses.replace(get_arch(arch), num_layers=DENSE_LAYERS)
        teacher_forced(torch, device, arch, cfg=cfg, profile=False)
    log(f"phase 12 (MoE and MLA): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: the hybrid family (hymba-1.5b): the selective-scan kernels and
# flash at hymba's shapes, full-width serving and training, then reduced
# float32 on the kernels against plain
# ---------------------------------------------------------------------------

HYMBA = "hymba-1.5b"
SSM_SHAPE = (4, 2048, 3200, 16)        # hymba-1.5b prefill: B, T, DI, S
SSM_TRAIN_SHAPE = (2, 256, 3200, 16)   # hymba-1.5b training: B, T, DI, S
SSM_DECODE_LAYERS = 32  # hymba-1.5b: one selective-scan call a layer a step
# every output and grad against its plain version: max |kernel - plain| /
# max |plain| (both keep the state in float32 and sum over the states,
# the channels and time in another order)
SSM_TOL = 1e-4
# the selective-scan backward's device ms before its redesign in segments
# (one thread a state walking 3T steps; chip_smoke.py phase 13, H100 80GB
# HBM3 at 700.00 W): training shape, prefill shape
SSM_BWD_EARLIER_MS = {"train": 0.2086, "prefill": 2.7419}
# the forward's device ms before its redesign in segments (8 lanes a
# channel, 2-buffer 4-byte cp.async staging; proof run 29, H100 80GB HBM3
# at 700.00 W): prefill shape, a decode call over 32 layers' calls
SSM_FWD_EARLIER_MS = {"prefill": 0.3719, "decode_step": 0.0030}
SSM_FWD_SWEEP = (1, 2, 4, 8)  # segment counts the forward is timed at
SSM_SMALL_SHAPE = (1, 4096, 128)  # B, T, DI: a few channels, a long T
SSM_LONG_T = 32768           # a forward with no limit on T
HYMBA_FLASH = (4, 2048, 25, 5, 64, 1024)  # B, S, H, KV, hd, window
HYMBA_REDUCED_SEQ = 128  # twice the reduced window: the window bites
# the full-width serve and teacher-forced step run 8 of hymba's 32 (alike)
# layers: phase 18 needed the time, and every layer repeats the same
# kernel calls at the same shapes (training keeps all 32)
HYMBA_SERVE_LAYERS = 8


def _sweep_shape(key):
    """(B, T, DI) of a segment sweep's shape by its name."""
    if key == "prefill":
        return SSM_SHAPE[:3]
    if key == "train":
        return SSM_TRAIN_SHAPE[:3]
    return SSM_SMALL_SHAPE


def ssm_inputs(torch, B, T, DI, S, device, seed, extreme=False):
    """float32 u, dt, B, C, A, a carried state, dy and a final-state grad:
    normal u, B, C, states and grads; dt the softplus of a normal shifted
    by the model's -2 ``dt_bias``, or ``extreme``: log-uniform over [1e-4,
    30], so exp(dt A) spans ~1 down to an exact 0; A = -exp(log(1..S) +
    0.1 normal), the reference's init moved a little."""
    gen = _gen(torch, device, seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    u = randn(B, T, DI)
    if extreme:
        lo, hi = float(np.log(1e-4)), float(np.log(30.0))
        dt = torch.exp(lo + (hi - lo) * torch.rand(B, T, DI, generator=gen,
                                                   device=device))
    else:
        dt = torch.nn.functional.softplus(randn(B, T, DI) - 2)
    Bm, Cm = randn(B, T, S), randn(B, T, S)
    A = -torch.exp(torch.log(torch.arange(1, S + 1, dtype=torch.float32,
                                          device=device))
                   + 0.1 * randn(DI, S))
    return u, dt, Bm, Cm, A, randn(B, DI, S), randn(B, T, DI), randn(B, DI, S)


def ssm_work(B, T, DI, S, carried, backward=False):
    """Bytes the function must move (float32; each input read once, each
    output written once; the backward's workspaces are its design's cost,
    not the function's) and its operations (``kernels/work.py``'s
    ``SSM_FWD_OPS`` or ``SSM_BWD_OPS`` an element)."""
    from repro_torch.kernels import work

    return work.ssm_work(B, T, DI, S, carried, backward)


def _rel(torch, got, want, what):
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{what} is not finite")
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def check_selective_scan(torch, ssk, ref, device):
    """Phase 13, the selective-scan kernels alone: the forward against
    ``selective_scan_ref`` at hymba's prefill shape from zero and from a
    carried state (y and the final state), at T = 1 (the step kernel), at
    a ragged T = 1000, with extreme dt, at the training shape and at T =
    32,768, two calls bitwise equal, and in each of 1..8 segments at the
    prefill and training shapes; the backward against ``selective_scan_bwd_ref``
    at the training shape (from zero; and from a carried state with a
    final-state grad and extreme dt), and from a carried state with a
    final-state grad at the prefill shape, at a ragged T = 1000 over eight
    segments, at hymba's train_4k length (B = 1) and at the longest T
    (B = 1, DI = 40; both past 48 KB of dynamic shared memory), every
    value finite and within SSM_TOL of max |plain|, two calls bitwise
    equal; then each timed (CUDA-graph replays) beside its bound, its
    plain version and its time before its redesign (the forward at the
    prefill, decode and training shapes, and by segment count), and the
    registers, shared memory and spills of each kernel.  Returns the
    JSON line's entries (launches, and the backward's launches a call,
    filled in by the main path)."""
    B, T, DI, S = SSM_SHAPE
    TB, TT = SSM_TRAIN_SHAPE[:2]
    cases = [("from zero", B, T, False, False),
             ("from a carried state", B, T, True, False),
             ("T=1 (decode), carried state", B, 1, True, False),
             ("ragged T=1000, carried state", B, 1000, True, False),
             ("extreme dt, carried state", B, T, True, True),
             ("the training shape, from zero", TB, TT, False, False),
             ("T=32,768 (no limit), carried state", 1, SSM_LONG_T, True,
              False)]
    err_main = 0.0
    for n, (what, b, t, carried, extreme) in enumerate(cases):
        u, dt, Bm, Cm, A, h0, _, _ = ssm_inputs(torch, b, t, DI, S, device,
                                                150 + n, extreme)
        state = h0 if carried else None
        got = ssk.selective_scan_cuda(u, dt, Bm, Cm, A, state=state)
        again = ssk.selective_scan_cuda(u, dt, Bm, Cm, A, state=state)
        torch.cuda.synchronize()
        want = ref.selective_scan_ref(u, dt, Bm, Cm, A, state=state)
        if not carried:
            got, again, want = (got,), (again,), (want,)
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        nseg = 0 if t == 1 else ssk.forward_segments(b, t, DI)
        name = (f"selective scan f32 (B={b}, T={t}, DI={DI}, S={S}; "
                + (f"{nseg} segment{'s' if nseg > 1 else ''} of "
                   f"{ssk.forward_segment_length(t, nseg)}" if nseg else
                   "the step kernel") + f") {what}")
        errs = {k: _rel(torch, g, w, f"{name}: {k}")
                for k, g, w in zip(("y", "final state"), got, want)}
        decay = ""
        if extreme:
            hi = float(torch.exp(dt.min() * A.max()))
            lo = float(torch.exp(dt.max() * A.min()))
            decay = f"; exp(dt A) from {hi:.6f} down to {lo:g}"
        log(f"{name}: max |kernel - plain| / max |plain| "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tolerance {SSM_TOL:g}); every value finite{decay}; two "
            f"calls bitwise equal: {same}")
        if max(errs.values()) > SSM_TOL:
            fail(f"{name} disagrees with its plain version: {errs}")
        if not same:
            fail(f"{name}: two calls on the same inputs differ")
        if what == "from a carried state":
            err_main = max(float((g - w).abs().max())
                           for g, w in zip(got, want))
        del u, dt, Bm, Cm, A, h0, got, again, want
    torch.cuda.empty_cache()
    # every segment count at a shape that fills the card with one and at
    # one that does not
    for b, t, seed in ((B, T, 158), (TB, TT, 159)):
        u, dt, Bm, Cm, A, h0, _, _ = ssm_inputs(torch, b, t, DI, S, device,
                                                seed, True)
        want = ref.selective_scan_ref(u, dt, Bm, Cm, A, state=h0)
        worst = 0.0
        for nseg in range(1, ssk.SEGMENTS + 1):
            got = ssk.selective_scan_cuda(u, dt, Bm, Cm, A, state=h0,
                                          segments=nseg)
            errs = [_rel(torch, g, w, f"selective scan {nseg} segments")
                    for g, w in zip(got, want)]
            worst = max(worst, *errs)
            if max(errs) > SSM_TOL:
                fail(f"selective scan (B={b}, T={t}) in {nseg} segments "
                     f"disagrees with its plain version: {errs}")
        log(f"selective scan f32 (B={b}, T={t}, DI={DI}), extreme dt, "
            f"carried state, in each of 1..{ssk.SEGMENTS} segments: worst "
            f"max |kernel - plain| / max |plain| {worst:.3e} (tolerance "
            f"{SSM_TOL:g})")
        del u, dt, Bm, Cm, A, h0, want
    torch.cuda.empty_cache()

    grads = ("du", "ddt", "dB", "dC", "dA", "dstate0")
    carried_grad = "carried state and final-state grad"
    bwd_cases = [("training shape, from zero", TB, TT, DI, False, False),
                 (f"training shape, {carried_grad}, extreme dt", TB, TT, DI,
                  True, True),
                 (f"prefill shape, {carried_grad}", B, T, DI, True, False),
                 (f"ragged T=1000, {carried_grad}", B, 1000, DI, True, False),
                 (f"hymba's train_4k length, {carried_grad}", 1, 4096, DI,
                  True, False),
                 (f"the longest T, {carried_grad}", 1, ssk.MAX_BACKWARD_T,
                  40, True, False)]
    err_bwd = 0.0
    for n, (what, b, t, di, carried, extreme) in enumerate(bwd_cases):
        u, dt, Bm, Cm, A, h0, dy, dh = ssm_inputs(torch, b, t, di, S, device,
                                                  160 + n, extreme)
        state, dfinal = (h0, dh) if carried else (None, None)
        got = ssk.selective_scan_bwd_cuda(u, dt, Bm, Cm, A, state, dy, dfinal)
        again = ssk.selective_scan_bwd_cuda(u, dt, Bm, Cm, A, state, dy,
                                            dfinal)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again)
                   if x is not None)
        want = ref.selective_scan_bwd_ref(u, dt, Bm, Cm, A, state, dy, dfinal)
        seg = ssk.segment_length(t)
        name = (f"selective scan backward (B={b}, T={t}, DI={di}; "
                f"{ssk.segments(t, seg)} segments of {seg}, "
                f"{ssk.backward_dynamic_shared_bytes(seg)} B of dynamic "
                f"shared memory a block) {what}")
        errs = {k: _rel(torch, g, w, f"{name}: {k}")
                for k, g, w in zip(grads, got, want) if w is not None}
        log(f"{name}: max |kernel - plain| / max |plain| "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tolerance {SSM_TOL:g}); every value finite; two calls "
            f"bitwise equal: {same}")
        if max(errs.values()) > SSM_TOL:
            fail(f"{name} disagrees with its plain version: {errs}")
        if not same:
            fail(f"{name}: two calls on the same inputs differ")
        if n == 0:
            err_bwd = max(float((g - w).abs().max())
                          for g, w in zip(got[:5], want[:5]))
        del u, dt, Bm, Cm, A, h0, dy, dh, got, again, want
    torch.cuda.empty_cache()

    attrs = [attributes_line(ssk.kernel_attributes(i))
             for i in range(len(ssk.KERNELS))]
    sets = [ssm_inputs(torch, B, T, DI, S, device, 170 + i) for i in range(2)]

    def fwd(fn, xs):
        return lambda i: fn(*xs[i][:5], state=xs[i][5])

    def fwd_at(xs, nseg):
        return lambda i: ssk.selective_scan_cuda(*xs[i][:5], state=xs[i][5],
                                                 segments=nseg)

    n0, nb0 = ssk.launches, ssk.backward_launches
    ms = device_ms(torch, fwd(ssk.selective_scan_cuda, sets), 2)
    plain_ms = device_ms(torch, fwd(ref.selective_scan_ref, sets), 2, reps=3)
    ms2 = device_ms(torch, fwd(ssk.selective_scan_cuda, sets), 2)
    sweep = {"prefill": {n: device_ms(torch, fwd_at(sets, n), 2)
                         for n in SSM_FWD_SWEEP}}
    del sets
    dec = [ssm_inputs(torch, B, 1, DI, S, device, 172 + i) for i in range(2)]
    dec_ms = device_ms(torch, fwd(ssk.selective_scan_cuda, dec), 2)
    dec_plain_ms = device_ms(torch, fwd(ref.selective_scan_ref, dec), 2)
    dec_layers = [ssm_inputs(torch, B, 1, DI, S, device, 180 + i)
                  for i in range(SSM_DECODE_LAYERS)]
    dec_step_ms = device_ms(torch, fwd(ssk.selective_scan_cuda, dec_layers),
                            SSM_DECODE_LAYERS)
    del dec, dec_layers
    # the training shape: the forward of a training step, from zero
    tsets = [ssm_inputs(torch, TB, TT, DI, S, device, 176 + i)[:5] + (None,)
             for i in range(2)]
    train_ms = device_ms(torch, fwd(ssk.selective_scan_cuda, tsets), 2)
    train_plain_ms = device_ms(torch, fwd(ref.selective_scan_ref, tsets), 2,
                               reps=3)
    sweep["train"] = {n: device_ms(torch, fwd_at(tsets, n), 2)
                      for n in SSM_FWD_SWEEP}
    del tsets
    # a long sequence over few channels, where one segment's blocks leave
    # most SMs idle
    sb, st_, sd = SSM_SMALL_SHAPE
    ssets = [ssm_inputs(torch, sb, st_, sd, S, device, 178 + i)
             for i in range(2)]
    sweep[f"small (B={sb}, T={st_}, DI={sd})"] = {
        n: device_ms(torch, fwd_at(ssets, n), 2) for n in SSM_FWD_SWEEP}
    del ssets
    nbytes, ops = ssm_work(B, T, DI, S, True)
    bound_ms, bound_by = bound(nbytes, ops, "f32 FFMA")
    nseg = ssk.forward_segments(B, T, DI)
    log(f"selective scan f32 with a carried state at hymba-1.5b's prefill "
        f"shape (B={B}, T={T}, DI={DI}, S={S}; {nseg} segment(s)): "
        f"{ms:.4f} ms on the device (again {ms2:.4f}; before the redesign "
        f"{SSM_FWD_EARLIER_MS['prefill']:.4f}, proof run 29), plain "
        f"{plain_ms:.4f} ms, library none, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B: "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {ops} ops at the FFMA "
        f"rate: {ops / FFMA_OPS * 1e3:.4f} ms); achieved "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s; {ssk.KERNELS[0]}: "
        f"{attrs[0]}")
    dec_bytes, dec_ops = ssm_work(B, 1, DI, S, True)
    dec_bound, dec_by = bound(dec_bytes, dec_ops, "f32 FFMA")
    log(f"selective scan f32 with a carried state at the decode shape (B={B}, "
        f"T=1, the step kernel): {dec_ms:.4f} ms on the device (two input "
        f"sets cycled), plain {dec_plain_ms:.4f} ms, {dec_step_ms:.4f} ms a "
        f"call over {SSM_DECODE_LAYERS} layers' calls, a state each (before "
        f"the redesign {SSM_FWD_EARLIER_MS['decode_step']:.4f}, proof run "
        f"29); bound {dec_bound:.4f} ms by {dec_by} ({dec_bytes} B, {dec_ops} "
        f"ops); {ssk.KERNELS[3]}: {attrs[3]}")
    t_bytes, t_ops = ssm_work(TB, TT, DI, S, False)
    train_bound, train_by = bound(t_bytes, t_ops, "f32 FFMA")
    log(f"selective scan f32 from zero at the training shape (B={TB}, "
        f"T={TT}; {ssk.forward_segments(TB, TT, DI)} segment(s)): "
        f"{train_ms:.4f} ms on the device, plain {train_plain_ms:.4f} ms, "
        f"bound {train_bound:.4f} ms by {train_by} ({t_bytes} B, {t_ops} "
        f"ops)")
    for key, times in sweep.items():
        log(f"selective scan forward at the {key} shape by segments: "
            + ", ".join(f"{n}: {t:.4f} ms" for n, t in times.items())
            + f" (the wrapper's choice {ssk.forward_segments(*_sweep_shape(key))})")

    times = {}
    for key, (b, t, carried) in (("train", (TB, TT, False)),
                                 ("prefill", (B, T, True))):
        sets = [ssm_inputs(torch, b, t, DI, S, device, 190 + i)
                for i in range(2)]

        def args(i):
            u, dt, Bm, Cm, A, h0, dy, dh = sets[i]
            return (u, dt, Bm, Cm, A, h0 if carried else None, dy,
                    dh if carried else None)

        def call(i):
            return ssk.selective_scan_bwd_cuda(*args(i))

        bms = device_ms(torch, call, 2)
        bplain = device_ms(torch, lambda i: ref.selective_scan_bwd_ref(
            *args(i)), 1, reps=1 if key == "prefill" else 3)
        bms2 = device_ms(torch, call, 2)
        nbytes, ops = ssm_work(b, t, DI, S, carried, backward=True)
        bbound, bby = bound(nbytes, ops, "f32 FFMA")
        ws_bytes = ssk.backward_workspace_bytes(b, t, DI, S)
        seg = ssk.segment_length(t)
        times[key] = (bms, bplain, bbound, bby)
        log(f"selective scan backward f32 at the {key} shape (B={b}, T={t}"
            f"{', carried state' if carried else ', from zero'}; "
            f"{ssk.segments(t, seg)} segments of {seg}): {bms:.4f} ms on the "
            f"device (again {bms2:.4f}; two input sets cycled, a call's "
            f"launches), before the redesign {SSM_BWD_EARLIER_MS[key]:.4f} "
            f"ms, plain {bplain:.4f} ms, library none, bound {bbound:.4f} ms "
            f"by {bby} ({nbytes} B: "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {ops} ops at the FFMA "
            f"rate: {ops / FFMA_OPS * 1e3:.4f} ms); workspace {ws_bytes} B "
            f"written and read ({2 * ws_bytes / HBM_BYTES_PER_S * 1e3:.4f} "
            f"ms at the memory rate); dynamic shared "
            f"{ssk.backward_dynamic_shared_bytes(seg)} B a block")
        del sets
        torch.cuda.empty_cache()
    ssk.launches, ssk.backward_launches = n0, nb0  # comparison launches
    for name, line in zip(ssk.KERNELS[1:3], attrs[1:3]):
        log(f"selective scan backward {name}: {line}")
    bms, bplain, bbound, bby = times["train"]
    return {"ssm": {
        "name": "selective_scan[f32,state]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/models/ssm.py:72",
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
        "train_ms": train_ms,
        "train_plain_ms": train_plain_ms,
        "train_bound_ms": train_bound,
        "segments_ms": {k: {str(n): t for n, t in v.items()}
                        for k, v in sweep.items()},
    }, "ssm_bwd": {
        "name": "selective_scan_bwd[f32,training shape]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/models/ssm.py:72",
        "launches": 0,
        "max_abs_err": err_bwd,
        "ms": bms,
        "plain_ms": bplain,
        "bound_ms": bbound,
        "bound_by": bby,
        "library_ms": None,
        "launches_per_call": None,  # from the training profile
        "prefill_ms": times["prefill"][0],
        "prefill_plain_ms": times["prefill"][1],
        "prefill_bound_ms": times["prefill"][2],
    }}


def check_flash_hymba(torch, fa, ref, F, device):
    """Phase 13, flash attention at hymba-1.5b's prefill attention (bf16,
    25 query heads over 5 kv heads, head dim 64, causal with a 1024-token
    window): against its plain version, then timed beside its bound, its
    plain version and ``scaled_dot_product_attention`` with the window as
    a boolean mask (kv heads repeated beforehand; the port never calls
    it).  Returns the JSON line's entry (launches filled in by the main
    path)."""
    B, S, H, KV, hd, W = HYMBA_FLASH
    q, k, v = flash_inputs(torch, B, S, H, KV, hd, "bf16", device, 140)
    got = fa.flash_attention_cuda(q, k, v, causal=True, window=W)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=W)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        fail("flash at hymba's shape: kernel output is not finite")
    err = float((got.float() - want.float()).abs().max())
    what = (f"flash attention bf16 B={B} S={S} H={H} KV={KV} hd={hd} causal "
            f"window {W}")
    log(f"{what}: max |kernel - plain| = {err:.3e} (tolerance "
        f"{FLASH_TOL['bf16']:g})")
    if err > FLASH_TOL["bf16"]:
        fail(f"{what} disagrees with its plain version: {err}")
    del q, k, v, got, want
    torch.cuda.empty_cache()

    sets = [flash_inputs(torch, B, S, H, KV, hd, "bf16", device, 141 + i)
            for i in range(2)]
    g = H // KV
    lib = [(q.transpose(1, 2).contiguous(),
            k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
            v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous())
           for q, k, v in sets]
    i = torch.arange(S, device=device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
    n0 = fa.launches
    ms = device_ms(torch, lambda j: fa.flash_attention_cuda(
        *sets[j], causal=True, window=W), 2)
    plain_ms = device_ms(torch, lambda j: ref.flash_attention_ref(
        *sets[j], causal=True, window=W), 2, reps=5)
    library_ms = device_ms(torch, lambda j: F.scaled_dot_product_attention(
        *lib[j], attn_mask=mask), 2)
    fa.launches = n0  # comparison launches do not count
    nbytes, ops = flash_work(B, S, H, KV, hd, "bf16", True, window=W)
    bound_ms, bound_by = bound(nbytes, ops, "bf16")
    log(f"{what}: {ms:.4f} ms on the device, plain {plain_ms:.4f} ms, "
        f"library (SDPA, window mask, kv heads repeated) {library_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, {ops} ops "
        f"over the visible pairs); achieved "
        f"{ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; "
        f"{attributes_line(fa.kernel_attributes(torch.bfloat16, hd))}")
    del sets, lib
    torch.cuda.empty_cache()
    return {"flash_bf16_hymba": {
        "name": f"flash_attention[bf16,causal,window {W},{H}/{KV} heads]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }}


def hymba_reduced_f32(torch, device):
    """The reduced float32 hymba (2 layers, window 64) on the kernels
    against the plain versions: bucketed WASH trained REDUCED_STEPS steps
    at HYMBA_REDUCED_SEQ tokens (final params within PARAM_TOL), then
    ``engine.generate`` in soup and ensemble over prompts longer than the
    window (greedy tokens identical); a state size the scan kernel lacks
    is refused on the card.  Returns the kernel runs' launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import population as pop
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.launch.serve import init_population
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.serving import engine

    cfg = get_arch(HYMBA).reduced()
    steps, seq = REDUCED_STEPS, HYMBA_REDUCED_SEQ
    mcfg = MixingConfig(kind="wash", base_p=0.01, mode="bucketed")
    torch.cuda.synchronize()
    _zero(fa, wkv, pa)
    ssk.backward_launches = 0
    res = _train(cfg, mcfg, "sgd", steps, device, seq=seq)
    torch.cuda.synchronize()
    fwd, bwd = ssk.launches, ssk.backward_launches
    kept = pop.tree_map(torch.clone, res.population)
    losses = res.history["loss"]
    del res
    with plain_routes(ops, ref, "selective_scan"), plain_shuffles(ops, ref):
        plain = _train(cfg, mcfg, "sgd", steps, device, seq=seq)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        pop.tree_leaves(kept), pop.tree_leaves(plain.population)))
    expect = cfg.num_layers * 2 * steps
    log(f"{cfg.name} (window {cfg.window}), bucketed WASH, SGD, {steps} "
        f"steps at {seq} tokens: selective-scan forward launches {fwd}, "
        f"backward calls {bwd} (expected {expect} each); max |param kernel "
        f"run - plain run| = {diff:.3e} (tolerance {PARAM_TOL:g}); losses "
        f"{losses} vs {plain.history['loss']}")
    if (fwd, bwd) != (expect, expect):
        fail(f"reduced hymba training: {fwd} forward / {bwd} backward "
             f"launches, expected {expect}")
    if diff > PARAM_TOL or not np.isfinite(losses).all():
        fail(f"reduced hymba training: kernel and plain runs differ by {diff}")
    launches = {"ssm": fwd, "ssm_bwd": bwd, "flash": 0}
    del kept, plain

    popn = init_population(cfg, 2, seed=8, device=device)
    batch = concrete_batch(cfg, 10, 4, 96, device=device)
    for mode in ("soup", "ensemble"):
        params = engine.serving_params(popn, mode)
        members = MODE_MEMBERS[mode]
        torch.cuda.synchronize()
        _zero(fa, wkv, pa)
        out_k = engine.generate(params, cfg, batch, 16, mode=mode,
                                device=device)
        torch.cuda.synchronize()
        counts = _counts(fa, wkv, pa)
        with plain_routes(ops, ref, "flash_attention", "selective_scan"):
            out_p = engine.generate(params, cfg, batch, 16, mode=mode,
                                    device=device)
        want = {"flash": cfg.num_layers * members, "paged": 0, "wkv": 0,
                "ssm": cfg.num_layers * members * 16}
        same = torch.equal(out_k, out_p)
        log(f"reduced f32 {HYMBA} {mode} (B=4, S=96 past the window of "
            f"{cfg.window}, 16 new): greedy tokens kernel path == plain "
            f"path: {same}; launches {counts} (expected {want})")
        if not same:
            fail(f"reduced f32 {HYMBA} {mode}: greedy tokens differ")
        if counts != want:
            fail(f"reduced f32 {HYMBA} {mode}: launches {counts}")
        launches["ssm"] += counts["ssm"]
        launches["flash"] += counts["flash"]
    state8 = dataclasses.replace(cfg, ssm_state=8)
    refused(f"engine.generate of {HYMBA} at ssm_state=8",
            lambda: engine.generate(params, state8, batch, 4, device=device),
            str(ssk.STATE_DIMS))
    del popn, params
    torch.cuda.empty_cache()
    return launches


def hybrid_family(torch, F, device, kernels, card):
    """Phase 13: the selective-scan kernels and flash at hymba's shapes
    alone; full-width hymba-1.5b served through the serve CLI's scan
    engine and its teacher-forced prefill and decode step; trained through
    the train CLI; then the reduced float32 hymba on the kernels against
    plain.  Adds the phase's entries to ``kernels`` with their launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ssk

    t0 = time.perf_counter()
    kernels.update(check_selective_scan(torch, ssk, ref, device))
    kernels.update(check_flash_hymba(torch, fa, ref, F, device))
    t1 = time.perf_counter()
    from repro_torch.configs import get_arch

    cut = dataclasses.replace(get_arch(HYMBA), num_layers=HYMBA_SERVE_LAYERS,
                              name=f"{HYMBA}-{HYMBA_SERVE_LAYERS}layers")
    counts = serve_full_width(torch, device, HYMBA, card, cfg=cut)
    kernels["ssm"]["launches"] += counts["ssm"]
    kernels["flash_bf16_hymba"]["launches"] += counts["flash"]
    teacher_forced(torch, device, HYMBA, cfg=cut)
    train_full_width(torch, device, HYMBA, kernels)
    reduced = hymba_reduced_f32(torch, device)
    kernels["ssm"]["launches"] += reduced["ssm"]
    kernels["ssm_bwd"]["launches"] += reduced["ssm_bwd"]
    kernels["flash_f32"]["launches"] += reduced["flash"]
    log(f"phase 13 (the hybrid family): {time.perf_counter() - t0:.1f} s "
        f"(the kernels alone {t1 - t0:.1f} s); selective-scan launches "
        f"{kernels['ssm']['launches']}, backward calls "
        f"{kernels['ssm_bwd']['launches']}, flash at hymba's shape "
        f"{kernels['flash_bf16_hymba']['launches']}, flash f32 (reduced) "
        f"{reduced['flash']}")


# ---------------------------------------------------------------------------
# phase 14: the last model families: whisper-medium's encoder-decoder over
# audio frames, internvl2-76b's vision prefix, DeepSeek-V2-Lite trained
# ---------------------------------------------------------------------------

WHISPER = "whisper-medium"
INTERNVL2 = "internvl2-76b"
# whisper's decoder context is 448 text tokens, up to 224 of them the
# previous window's text (arXiv:2212.04356): its served prompt length
WHISPER_PROMPT = 224
# the flash kernel at the phase's new shapes: B, S, H, KV, hd, causal
WHISPER_FLASH = (4, 1500, 16, 16, 64, False)       # the encoder's frames
WHISPER_DEC_FLASH = (4, WHISPER_PROMPT, 16, 16, 64, True)  # decoder prefill
INTERNVL2_FLASH = (4, 256 + 2048, 64, 8, 128, True)  # patches + prompt
# each shape's entry key, its label in the entry's name, and its dtypes
NEW_FLASH_SHAPES = (
    ("whisper", "whisper's encoder", WHISPER_FLASH, ("bf16", "f32")),
    ("whisper_dec", "whisper's decoder prefill", WHISPER_DEC_FLASH,
     ("bf16", "f32")),
    ("internvl2", "internvl2's prefill", INTERNVL2_FLASH, ("bf16",)))
CUT_LAYERS = 4  # internvl2-76b (of 80) and DeepSeek-V2-Lite (of 27)
# the reduced float32 whisper keeps the full model's attention widths and
# frame count, so its flash launches fall at WHISPER_FLASH and
# WHISPER_DEC_FLASH (in float32)
WHISPER_WIDTHS = dict(d_model=1024, num_heads=16, num_kv_heads=16,
                      num_frames=1500)


def check_flash_new_shapes(torch, fa, ref, F, device):
    """Phase 14, the kernel alone: flash attention at whisper-medium's
    encoder (non-causal over 1500 frames, 16 heads of 64) and decoder
    prefill (causal over the 224-token prompt, 16 heads of 64), each in
    bf16 and f32, and at internvl2-76b's prefill behind its patches
    (causal, 64 query heads over 8 kv heads of 128, S = 256 + 2048; bf16)
    against its plain version, then timed beside its bound, its plain
    version and ``scaled_dot_product_attention`` on the same inputs (kv
    heads repeated beforehand; the port never calls it).  Returns the
    JSON line's entries (launches filled in by the main path)."""
    entries = {}
    for key, label, shape, dts in NEW_FLASH_SHAPES:
        B, S, H, KV, hd, causal = shape
        g = H // KV
        what = (f"flash attention at {label} shape (B={B} S={S} H={H} "
                f"KV={KV} hd={hd} {'causal' if causal else 'non-causal'})")
        for n, dt in enumerate(dts):
            q, k, v = flash_inputs(torch, B, S, H, KV, hd, dt, device, 150 + n)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = ref.flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if got.shape != q.shape or not torch.isfinite(got.float()).all():
                fail(f"{what} {dt}: output {tuple(got.shape)} not finite or "
                     "of the wrong shape")
            err = float((got.float() - want.float()).abs().max())
            log(f"{what} {dt}: max |kernel - plain| = {err:.3e} (tolerance "
                f"{FLASH_TOL[dt]:g})")
            if err > FLASH_TOL[dt]:
                fail(f"{what} {dt} disagrees with its plain version: {err}")
            del q, k, v, got, want
            torch.cuda.empty_cache()
            sets = [flash_inputs(torch, B, S, H, KV, hd, dt, device, 160 + i)
                    for i in range(2)]
            lib = [tuple(x.repeat_interleave(g if j else 1, dim=2)
                         .transpose(1, 2).contiguous()
                         for j, x in enumerate(xs)) for xs in sets]
            n0 = fa.launches
            ms = device_ms(torch, lambda j: fa.flash_attention_cuda(
                *sets[j], causal=causal), 2)
            # one input set: the plain version holds B H S S float32 scores
            plain_ms = device_ms(torch, lambda j: ref.flash_attention_ref(
                *sets[0], causal=causal), 1, reps=3)
            library_ms = device_ms(
                torch, lambda j: F.scaled_dot_product_attention(
                    *lib[j], is_causal=causal), 2)
            fa.launches = n0  # comparison launches do not count
            nbytes, ops = flash_work(B, S, H, KV, hd, dt, causal)
            bound_ms, bound_by = bound(nbytes, ops, dt)
            log(f"{what} {dt}: {ms:.4f} ms on the device, plain "
                f"{plain_ms:.4f} ms, library (SDPA, kv heads repeated) "
                f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes} B, {ops} ops over the visible pairs); achieved "
                f"{ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; " + attributes_line(
                    fa.kernel_attributes(sets[0][0].dtype, hd)))
            entries[f"flash_{dt}_{key}"] = {
                "name": f"flash_attention[{dt},{label}: "
                        f"{'causal' if causal else 'non-causal'} S={S},"
                        f"{H}/{KV} heads,hd {hd}]",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:77",
                "launches": 0,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
            }
            del sets, lib
            torch.cuda.empty_cache()
    return entries


def split_flash_launches(torch, got, kernels, dt, expect, what):
    """Add a path's flash launches to the phase's entries by shape: ``got``
    is ``flash_attention.launch_shapes`` as the path left it (cleared with
    the counts before it), ``expect`` maps entry keys of NEW_FLASH_SHAPES
    to the launches the path must make at each one's shape in ``dt``.  A
    launch at any other shape fails the run."""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    shapes = {key: shape for key, _, shape, _ in NEW_FLASH_SHAPES}
    want = {}
    for key, n in expect.items():
        B, S, H, KV, hd, causal = shapes[key]
        want[(dtype, B, S, H, KV, hd, hd, causal, None)] = n
    log(f"{what}: flash launches by (dtype, B, S, H, KV, hd, hd_v, causal, "
        f"window) {dict(got)} (expected {want})")
    if dict(got) != want:
        fail(f"{what}: flash launches by shape {dict(got)}, expected {want}")
    for key, n in expect.items():
        kernels[f"flash_{dt}_{key}"]["launches"] += n


def serve_internvl2(torch, device, card):
    """internvl2-76b at full width and CUT_LAYERS of its 80 layers, a
    random N=2 bf16 population from seed 0 averaged in place, served as
    the soup through the scan engine: B=SCAN_B, 256 patches + 2048 prompt
    tokens, SCAN_NEW new, twice (the first request and the timed one).
    Every prefill attention goes through the flash kernel (launches ==
    2 requests x CUT_LAYERS).  Returns the launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import averaging
    from repro_torch.core.population import tree_leaves
    from repro_torch.core.prng import fold_in
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch.serve import init_population
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.serving import engine

    cfg = dataclasses.replace(get_arch(INTERNVL2), num_layers=CUT_LAYERS,
                              name=f"{INTERNVL2}-{CUT_LAYERS}layers")
    S = INTERNVL2_FLASH[1] - cfg.num_patches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    popn = init_population(cfg, 2, seed=0, device=device)
    one_model = sum(x.numel() * x.element_size()
                    for x in tree_leaves(popn)) // 2
    soup = averaging.uniform_soup_(popn)
    batch = concrete_batch(cfg, fold_in(0, 2), SCAN_B, S, device=device)
    expect = {"flash": REQUESTS_PER_MODE * cfg.num_layers, "paged": 0,
              "wkv": 0, "ssm": 0}
    _zero(fa, wkv, pa)
    t1 = time.perf_counter()
    engine.generate(soup, cfg, batch, SCAN_NEW, device=device)
    torch.cuda.synchronize()
    first = time.perf_counter() - t1
    split = {}
    t1 = time.perf_counter()
    toks = engine.generate(soup, cfg, batch, SCAN_NEW, device=device,
                           timings=split)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t1
    counts = _counts(fa, wkv, pa)
    peak = torch.cuda.max_memory_allocated()
    step_ms = split["decode_s"] * 1e3 / (SCAN_NEW - 1)
    log(f"scan engine {cfg.name} (full width, {cfg.num_layers} of 80 layers, "
        f"bf16, N=2 = {2 * one_model / 2**30:.2f} GiB of weights, the soup "
        f"made in place; B={SCAN_B}, {cfg.num_patches} patches + {S} prompt "
        f"tokens, {SCAN_NEW} new, twice): "
        f"{time.perf_counter() - t0:.2f} s with the population's init; "
        f"{SCAN_B * SCAN_NEW / steady:.2f} tok/s (timed request "
        f"{steady:.3f} s: prefill {split['prefill_s']:.3f} s, decode step "
        f"{step_ms:.2f} ms; first request {first:.2f} s); kernel launches "
        f"{counts} (expected {expect}); peak allocated {peak / 2**30:.2f} "
        f"GiB; on {card}")
    if counts != expect:
        fail(f"{cfg.name}: kernel launches {counts}, expected {expect}")
    if (toks.shape != (SCAN_B, S + SCAN_NEW)
            or not torch.equal(toks[:, :S].long(), batch["tokens"].long())
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size):
        fail(f"{cfg.name}: tokens of shape {tuple(toks.shape)}, or the prompt "
             "lost, or sampled out of the vocabulary")
    del popn, soup, batch
    torch.cuda.empty_cache()
    return counts["flash"]


def last_families_reduced_f32(torch, device):
    """Reduced float32 whisper, internvl2 and DeepSeek (at the full model's
    MLA widths) on the card (TF32 off), kernels against plain: REDUCED_STEPS
    steps of bucketed WASH (p = 0.1) on the shuffle kernels and on their
    plain versions, final params within PARAM_TOL; then ``engine.generate``
    in soup and ensemble on the flash kernel and on its plain version,
    greedy tokens identical (flash launches == attention layers, encoder
    included, x members).  Whisper keeps WHISPER_WIDTHS and is prompted
    with WHISPER_PROMPT tokens.  Returns the kernel runs' flash launches
    per arch, by shape (``flash_attention.launch_shapes``)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import population as pop
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.launch.serve import init_population
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.serving import engine

    launches = {}
    mcfg = MixingConfig(kind="wash", base_p=0.1, mode="bucketed")
    for arch, cfg, S in (
            (WHISPER, get_arch(WHISPER).reduced(**WHISPER_WIDTHS),
             WHISPER_PROMPT),
            (INTERNVL2, get_arch(INTERNVL2).reduced(), 64),
            (DEEPSEEK, get_arch(DEEPSEEK).reduced(**MLA_WIDTHS), 64)):
        torch.cuda.synchronize()
        ws.bucketed_launches = 0
        res = _train(cfg, mcfg, "sgd", REDUCED_STEPS, device)
        torch.cuda.synchronize()
        shuffles = ws.bucketed_launches
        kept = pop.tree_map(torch.clone, res.population)
        losses = res.history["loss"]
        del res
        with plain_shuffles(ops, ref):
            plain = _train(cfg, mcfg, "sgd", REDUCED_STEPS, device)
        diff = max(float((a - b).abs().max()) for a, b in zip(
            pop.tree_leaves(kept), pop.tree_leaves(plain.population)))
        log(f"reduced f32 {cfg.name}, bucketed WASH p=0.1, SGD, "
            f"{REDUCED_STEPS} steps: {shuffles} bucketed shuffle launches; "
            f"max |param kernel run - plain run| = {diff:.3e} (tolerance "
            f"{PARAM_TOL:g}); losses {losses} vs {plain.history['loss']}")
        if not shuffles or diff > PARAM_TOL or not np.isfinite(losses).all():
            fail(f"reduced f32 {cfg.name} training: {shuffles} shuffles, "
                 f"kernel and plain runs differ by {diff}")
        del kept, plain

        popn = init_population(cfg, 2, seed=9, device=device)
        batch = concrete_batch(cfg, 11, 4, S, device=device)
        launches[arch] = collections.Counter()
        for mode in ("soup", "ensemble"):
            params = engine.serving_params(popn, mode)
            torch.cuda.synchronize()
            _zero(fa, wkv, pa)
            out_k = engine.generate(params, cfg, batch, 16, mode=mode,
                                    device=device)
            torch.cuda.synchronize()
            n = fa.launches
            launches[arch] += fa.launch_shapes
            with plain_routes(ops, ref, "flash_attention"):
                out_p = engine.generate(params, cfg, batch, 16, mode=mode,
                                        device=device)
            expect = ((cfg.num_layers + cfg.encoder_layers)
                      * MODE_MEMBERS[mode])
            same = torch.equal(out_k, out_p)
            log(f"reduced f32 {cfg.name} {mode} (B=4, S={S}, 16 new): greedy "
                f"tokens kernel path == plain path: {same}; flash launches "
                f"{n} (expected {expect})")
            if not same or n != expect:
                fail(f"reduced f32 {cfg.name} {mode}: tokens differ or {n} "
                     "flash launches")
        del popn, params
        torch.cuda.empty_cache()
    return launches


def last_families(torch, F, device, kernels, card):
    """Phase 14: flash at the new shapes alone; full-width whisper-medium
    served through the serve CLI's scan engine and trained through the
    train CLI; DeepSeek-V2-Lite at full width and CUT_LAYERS layers
    trained through the train CLI's ``main`` and its soup served; the
    flash launches of whisper's runs counted by shape; internvl2-76b at
    full width and CUT_LAYERS layers served as the soup; then the reduced
    float32 models on the kernels against plain.  Adds the phase's entries
    to ``kernels`` with their launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    t0 = time.perf_counter()
    kernels.update(check_flash_new_shapes(torch, fa, ref, F, device))
    t1 = time.perf_counter()
    whisper = get_arch(WHISPER)
    members = sum(MODE_MEMBERS.values())
    serve_full_width(torch, device, WHISPER, card, seq=WHISPER_PROMPT)
    split_flash_launches(torch, fa.launch_shapes, kernels, "bf16", {
        "whisper": REQUESTS_PER_MODE * whisper.encoder_layers * members,
        "whisper_dec": REQUESTS_PER_MODE * whisper.num_layers * members},
        f"{WHISPER} served")
    train_full_width(torch, device, WHISPER, kernels)
    deepseek = dataclasses.replace(get_arch(DEEPSEEK), num_layers=CUT_LAYERS,
                                   name=f"{DEEPSEEK}-{CUT_LAYERS}layers")
    train_full_width(torch, device, DEEPSEEK, kernels, cfg=deepseek)
    kernels["flash_bf16_internvl2"]["launches"] += serve_internvl2(
        torch, device, card)
    reduced = last_families_reduced_f32(torch, device)
    small = get_arch(WHISPER).reduced(**WHISPER_WIDTHS)
    runs = sum(MODE_MEMBERS[m] for m in ("soup", "ensemble"))
    split_flash_launches(torch, reduced[WHISPER], kernels, "f32", {
        "whisper": small.encoder_layers * runs,
        "whisper_dec": small.num_layers * runs},
        f"reduced f32 {small.name} served")
    kernels["flash_f32"]["launches"] += sum(reduced[INTERNVL2].values())
    kernels["flash_f32_mla"]["launches"] += sum(reduced[DEEPSEEK].values())
    log(f"phase 14 (the last model families): {time.perf_counter() - t0:.1f} "
        f"s (the kernels alone {t1 - t0:.1f} s); flash launches at whisper's "
        f"encoder {kernels['flash_bf16_whisper']['launches']} (bf16) and "
        f"{kernels['flash_f32_whisper']['launches']} (f32, reduced), at its "
        f"decoder prefill {kernels['flash_bf16_whisper_dec']['launches']} "
        f"(bf16) and {kernels['flash_f32_whisper_dec']['launches']} (f32, "
        f"reduced), at internvl2's "
        f"{kernels['flash_bf16_internvl2']['launches']}")


# ---------------------------------------------------------------------------
# phase 15: multi-device training, the ensemble engine at world 1
# ---------------------------------------------------------------------------

ENGINE_RECORD_EVERY = 2   # (a): a record every 2 of TRAIN_STEPS steps
ENGINE_LOSS_RTOL = 1e-2   # (a): against phase 5's vmap loop, bf16
ENGINE_ROUNDS = 2         # (a): interleaved timing rounds, loop and engine


def engine_full_width(torch, device, kernels, phase5) -> dict:
    """(a) Full-width llama3.2-3b (bf16, N = 2, SGD, bucketed WASH at
    p = 0.01, 2 x TRAIN_SEQ tokens a member, TRAIN_STEPS steps, a record
    every ENGINE_RECORD_EVERY) through the train CLI's ``main`` with
    ``--engine shard_map``: every shuffle through the bucketed kernel and
    held bitwise against its plain version, the comm exactly
    ``TRAIN_PLANS``' a step, one chunk function built, finite losses
    within ENGINE_LOSS_RTOL of phase 5's vmap loop from the same seed
    (``phase5``: ``train_full_width``'s result); then the same run
    unchecked through the vmap loop, the engine with the staging thread
    and the engine with ``--sync-staging``, interleaved for
    ENGINE_ROUNDS rounds, for the step split, tokens/s and peak memory.
    Adds its bucketed launches to ``kernels``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.launch import train as train_cli
    from repro_torch.train import engine

    arch, n, steps = "llama3.2-3b", 2, TRAIN_STEPS
    leaves, step_comm = TRAIN_PLANS[arch]
    argv = training_argv(arch, device)
    argv[argv.index("--record-every") + 1] = str(ENGINE_RECORD_EVERY)
    argv += ["--engine", "shard_map"]
    seen, counts = {"plans": []}, {"dense": 0, "bucketed": 0}
    torch.cuda.synchronize()
    ws.bucketed_launches = ws.wash_launches = 0
    _zero(fa, wkv, pa)
    engine.reset_chunk_trace_count()
    t0 = time.perf_counter()
    with checked_shuffles(ops, ref, torch, counts), \
            watch_bucketed_shuffles(ops, 0, seen):
        res = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, built = ws.bucketed_launches, engine.chunk_trace_count()
    other = _counts(fa, wkv, pa)
    sent = [k_n * k_per * (n - 1) / n for k_n, k_per in seen["plans"]]
    applied = [sum(sent[i:i + leaves]) for i in range(0, len(sent), leaves)]
    recorded = res.history["comm"]
    want_comm = [step_comm * (s + 1) for s in res.history["step"]]
    rel = [abs(loss - phase5["loss"][s]) / abs(phase5["loss"][s])
           for s, loss in zip(res.history["step"], res.history["loss"])]
    log(f"training ({arch}, 28 layers, bf16, N={n}, SGD, bucketed WASH "
        f"p=0.01, 2 x {TRAIN_SEQ} tokens per member, {steps} steps, a "
        f"record every {ENGINE_RECORD_EVERY}) through launch.train.main "
        f"--engine shard_map (world 1), every shuffle held against its plain "
        f"version: {wall:.2f} s; chunk functions built {built} (expected 1); "
        f"bucketed shuffle launches {launches} (expected {leaves} x {steps}),"
        f" {counts['bucketed']} of them bitwise equal to the plain version, "
        f"dense {ws.wash_launches}; other kernels' launches {other} "
        f"(expected none); comm per step of the plans applied {applied}, "
        f"recorded {recorded} at steps {res.history['step']} (expected "
        f"{want_comm}); losses {res.history['loss']} against phase 5's vmap "
        f"loop {[phase5['loss'][s] for s in res.history['step']]}: relative "
        f"differences {rel} (tolerance {ENGINE_LOSS_RTOL:g})")
    if (launches != leaves * steps or counts["bucketed"] != launches
            or ws.wash_launches or any(other.values())):
        fail(f"engine training: {launches} bucketed launches "
             f"({counts['bucketed']} checked), {ws.wash_launches} dense, "
             f"other kernels {other}")
    if (applied != [step_comm] * steps or recorded != want_comm
            or res.comm_scalars != step_comm * steps):
        fail(f"engine training: comm {applied} applied a step, {recorded} "
             f"recorded, expected {step_comm} a step")
    if built != 1 or res.history["step"] != [0, 2, 3]:
        fail(f"engine training: {built} chunk functions built, records at "
             f"{res.history['step']}")
    if not np.isfinite(res.history["loss"]).all() or max(rel) > ENGINE_LOSS_RTOL:
        fail(f"engine training: losses {res.history['loss']}, relative "
             f"differences to the vmap loop {rel}")
    kernels["bucketed"]["launches"] += launches
    history = {k: list(res.history[k]) for k in ("step", "loss", "comm")}
    del res, seen
    torch.cuda.empty_cache()

    # the loop and both stagings interleaved, ENGINE_ROUNDS rounds in this
    # one process: host time drifts over a long run, so a comparison with
    # phase 5, minutes earlier, cannot tell the engine's cost from drift
    loop_argv = argv[:argv.index("--engine")]
    variants = {"vmap loop": loop_argv, "engine, staging thread": argv,
                "engine, --sync-staging": argv + ["--sync-staging"]}
    timing = {name: [] for name in variants}
    for rnd in range(ENGINE_ROUNDS):
        for name, av in variants.items():
            timing[name].append(timed_training_run(
                torch, lambda: train_cli.main(av),
                f"{arch} training, {name} (round {rnd + 1})"))
            torch.cuda.empty_cache()
    p5 = phase5["timing"]
    for name, runs in timing.items():
        log(f"{arch} training, a record every {ENGINE_RECORD_EVERY}, {name}, "
            f"{ENGINE_ROUNDS} interleaved rounds: steps 2.. "
            f"{[round(t['steps2_ms'], 1) for t in runs]} ms a step in the "
            f"three phases, {[round(t['tok_s'], 1) for t in runs]} tokens/s, "
            f"peak {max(t['peak_gib'] for t in runs):.2f} GiB (phase 5's "
            f"loop: {p5['steps2_ms']:.1f} ms, {p5['tok_s']:.1f} tokens/s, "
            f"{p5['peak_gib']:.2f} GiB)")
    PEAK_GIB["engine"] = max(t["peak_gib"] for name, runs in timing.items()
                             if name != "vmap loop" for t in runs)
    return history


def engine_reduced_f32(torch, device) -> None:
    """(b) llama3.2-3b at full width and REDUCED_LAYERS layers in float32
    (phase 6's size), REDUCED_STEPS steps on the kernels, the ensemble
    engine against the vmap loop, final params within PARAM_TOL: bucketed
    WASH+Opt under AdamW (the bucketed kernel on params, ``mu`` and
    ``nu``); PAPA (``papa_every=2``) with the gate split and without it
    (one chunk function a variant of the schedule: 2 both ways, PAPA's
    first window never mixing; one chunk a record window without the
    split); synchronous staging against the staging thread (bucketed
    WASH, SGD)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import population as pop
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.train import engine

    base = get_arch("llama3.2-3b")
    steps = REDUCED_STEPS
    cfg = dataclasses.replace(base, num_layers=REDUCED_LAYERS, dtype="float32",
                              name=f"{base.name}-{REDUCED_LAYERS}layers-f32")

    def run(mcfg, optimizer, **opts):
        """The population after ``steps``, the bucketed launches and the
        chunk functions built."""
        torch.cuda.synchronize()
        ws.bucketed_launches = 0
        engine.reset_chunk_trace_count()
        res = _train(cfg, mcfg, optimizer, steps, device, **opts)
        torch.cuda.synchronize()
        out = (pop.tree_map(torch.clone, res.population), ws.bucketed_launches,
               engine.chunk_trace_count(), res.history["loss"])
        del res
        torch.cuda.empty_cache()
        return out

    def diff(a, b) -> float:
        return max(float((x - y).abs().max()) for x, y in zip(
            pop.tree_leaves(a), pop.tree_leaves(b)))

    wash_opt = MixingConfig(kind="wash_opt", base_p=0.01, mode="bucketed")
    papa = MixingConfig(kind="papa", papa_every=2)
    wash = MixingConfig(kind="wash", base_p=0.01, mode="bucketed")
    leaves = TRAIN_PLANS[base.name][0]
    checks = [
        ("WASH+Opt, AdamW", wash_opt, "adamw", {}, leaves * 3 * steps, 1),
        ("PAPA, gate split", papa, "sgd", {}, 0, 2),
        ("PAPA, --no-gate-split", papa, "sgd", {"split_gate_runs": False}, 0,
         2),
    ]
    loops = {}
    for what, mcfg, optimizer, opts, want_launches, want_built in checks:
        if mcfg not in loops:
            loops[mcfg] = run(mcfg, optimizer)
        got, launches, built, losses = run(mcfg, optimizer,
                                           engine="shard_map", **opts)
        sched = engine.build_schedule(steps, steps, mcfg, **opts)
        d = diff(got, loops[mcfg][0])
        log(f"{cfg.name}, {what}, {steps} steps, engine (world 1) against the "
            f"vmap loop: max |param engine - loop| = {d:.3e} (tolerance "
            f"{PARAM_TOL:g}); bucketed launches {launches} (loop "
            f"{loops[mcfg][1]}, expected {want_launches}); chunk functions "
            f"built {built} (expected {want_built}) for {len(sched.chunks)} "
            f"chunks; losses {losses} vs {loops[mcfg][3]}")
        if (d > PARAM_TOL or launches != want_launches
                or loops[mcfg][1] != want_launches or built != want_built
                or not np.isfinite(losses).all()):
            fail(f"reduced f32 engine, {what}: params differ by {d}, "
                 f"{launches} launches, {built} chunk functions")
        del got
    del loops
    torch.cuda.empty_cache()
    sync, _, _, _ = run(wash, "sgd", engine="shard_map", async_staging=False)
    asyn, launches, _, _ = run(wash, "sgd", engine="shard_map",
                               async_staging=True)
    d = diff(sync, asyn)
    log(f"{cfg.name}, bucketed WASH, SGD: --sync-staging against the staging "
        f"thread: max |param sync - async| = {d:.3e} (tolerance "
        f"{PARAM_TOL:g}); bucketed launches {launches} (expected "
        f"{leaves * steps})")
    if d > PARAM_TOL or launches != leaves * steps:
        fail(f"reduced f32 engine: sync and async staging differ by {d}")
    del sync, asyn
    torch.cuda.empty_cache()


def engine_refuses_two_ranks_on_one_card(torch, device) -> None:
    """(c) An engine asked for world 2 (torchrun's environment) on one
    card is refused before any weight is made, with the one-card-per-rank
    reason."""
    import os

    from repro_torch.launch import train as train_cli

    saved = {k: os.environ.get(k) for k in ("WORLD_SIZE", "RANK")}
    os.environ.update(WORLD_SIZE="2", RANK="0")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        train_cli.main(training_argv("llama3.2-3b", device)
                       + ["--engine", "shard_map"])
    except ValueError as e:
        reason = str(e)
    else:
        fail("the engine at world 2 on one card was not refused")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    after = torch.cuda.memory_allocated()
    log(f"the engine asked for world 2 on {torch.cuda.device_count()} card: "
        f"refused: {reason}; device memory {before} -> {after} bytes")
    if "one card per rank" not in reason or after != before:
        fail(f"two ranks on one card: refused with {reason!r}, memory "
             f"{before} -> {after}")


def multi_device_training(torch, device, kernels, phase5) -> dict:
    """Phase 15: the ensemble engine (``--engine shard_map``) at world 1
    on the card: (a) full width against phase 5, (b) reduced f32 against
    the vmap loop, (c) the refusal of two ranks on one card.  Returns
    (a)'s history (steps, losses, comm), phase 16's yardstick."""
    t0 = time.perf_counter()
    history = engine_full_width(torch, device, kernels, phase5)
    engine_reduced_f32(torch, device)
    engine_refuses_two_ranks_on_one_card(torch, device)
    log(f"phase 15 (multi-device training, world 1): "
        f"{time.perf_counter() - t0:.1f} s; bucketed launches on the main "
        f"paths so far {kernels['bucketed']['launches']}")
    return history


# ---------------------------------------------------------------------------
# phase 16: training on ens×data×model meshes, at world 1 on the card; the
# planner's four-card layouts on the host
# ---------------------------------------------------------------------------

#: full-width llama3.2-3b, bucketed p = 0.01: (mesh (E, D, M), N) -> the
#: scalars a member sends a mixing step under WASH and under WASH+Opt with
#: AdamW, from the JAX package's planner (``static_shard_mix_comm`` over
#: ``sharding.rules.param_pspecs`` specs); tests/test_torch_shardplan.py
#: holds the port's planner to it on the CPU
MESH_COMM = {((1, 1, 1), 2): (9016867.0, 27050601.0),
             ((2, 1, 2), 2): (9016816.0, 27050448.0),
             ((1, 1, 4), 2): (9016712.0, 27050136.0),
             ((2, 2, 1), 2): (9016867.0, 27050601.0),
             ((2, 2, 1), 4): (13525293.0, 40575879.0)}


def mesh_layouts() -> None:
    """On the host: for each layout of MESH_COMM, the shard-local planner's
    comm (held to MESH_COMM exactly) and what a card holds under AdamW
    WASH+Opt: its parameter shards (bf16), their two f32 moments, one
    member's gradient (bf16) at a time and, when leaves are split, the
    member gathered whole for it."""
    import types

    from repro_torch.configs import get_arch
    from repro_torch.core import shardplan
    from repro_torch.core.layer_index import infer_layer_ids, total_layers
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.core.population import tree_leaves
    from repro_torch.models import transformer as M
    from repro_torch.sharding import rules

    cfg = get_arch("llama3.2-3b")
    shapes = M.param_shapes(cfg)
    lids = infer_layer_ids(shapes, cfg.num_layers)
    tl = total_layers(cfg.num_layers)
    member = sum(int(np.prod(x.shape)) for x in tree_leaves(shapes))
    gib = 2 ** 30
    for (shape, n), want in MESH_COMM.items():
        mesh = types.SimpleNamespace(
            axis_names=("ens", "data", "model"),
            shape=dict(zip(("ens", "data", "model"), shape)))
        specs = rules.param_pspecs(shapes, cfg, mesh)
        got = []
        for kind in ("wash", "wash_opt"):
            pplan = shardplan.plan_population_mixing(
                mesh, shapes, specs,
                MixingConfig(kind=kind, base_p=0.01, mode="bucketed"), lids,
                tl, n)
            got.append(shardplan.static_shard_mix_comm(
                pplan, {"mu": None, "nu": None, "step": None}
                if kind == "wash_opt" else None))
        local = pplan.n_local * sum(int(np.prod(i.local_shape))
                                    for i in pplan.infos)
        split = sum(bool(i.sharded_dims) for i in pplan.infos)
        held = {"params": 2 * local, "moments": 8 * local,
                "member": 2 * member if pplan.any_sharded else 0,
                "grad": 2 * member}
        log(f"layout {shape} N={n}: population over {pplan.pop_axes}, "
            f"batches over {pplan.dp_axes or '-'}, {split} of "
            f"{len(pplan.infos)} leaves split; comm a member a step: WASH "
            f"{got[0]!r}, WASH+Opt (AdamW) {got[1]!r} (expected {want}); a "
            f"card holds {pplan.n_local} member shard(s): params "
            f"{held['params'] / gib:.2f} GiB, AdamW moments "
            f"{held['moments'] / gib:.2f} GiB, a gathered member "
            f"{held['member'] / gib:.2f} GiB, a member's gradient "
            f"{held['grad'] / gib:.2f} GiB: {sum(held.values()) / gib:.2f} "
            f"GiB before activations")
        if tuple(got) != want:
            fail(f"layout {shape} N={n}: the planner's comm {got}, the "
                 f"reference's {want}")


def multi_axis_training(torch, device, kernels, phase15) -> None:
    """Phase 16: full-width llama3.2-3b (bf16, N = 2, SGD, bucketed WASH
    at p = 0.01, 2 x TRAIN_SEQ tokens a member, TRAIN_STEPS steps, a
    record every ENGINE_RECORD_EVERY) through the train CLI's ``main``
    with ``--engine shard_map --mesh ens_dp_mp`` at world 1: the fill
    gives the (1, 1, 1) mesh, so the shard-local planner runs and the
    single-axis body trains with every planned leaf through the bucketed
    kernel (held bitwise against its plain version).  Held to phase 15
    (``phase15``: its history): losses equal, the comm exactly
    ``TRAIN_PLANS``' a step, one chunk function; the peak memory.  Then
    :func:`mesh_layouts` on the host.  Adds its bucketed launches to
    ``kernels``."""
    import io

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.launch import train as train_cli
    from repro_torch.train import engine

    t0 = time.perf_counter()
    arch, n, steps = "llama3.2-3b", 2, TRAIN_STEPS
    leaves, step_comm = TRAIN_PLANS[arch]
    argv = training_argv(arch, device)
    argv[argv.index("--record-every") + 1] = str(ENGINE_RECORD_EVERY)
    argv += ["--engine", "shard_map", "--mesh", "ens_dp_mp"]
    seen, counts = {"plans": []}, {"dense": 0, "bucketed": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ws.bucketed_launches = ws.wash_launches = 0
    _zero(fa, wkv, pa)
    engine.reset_chunk_trace_count()
    out = io.StringIO()
    t1 = time.perf_counter()
    with checked_shuffles(ops, ref, torch, counts), \
            watch_bucketed_shuffles(ops, 0, seen), \
            contextlib.redirect_stdout(out):
        res = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2**30
    printed = out.getvalue()
    for line in printed.splitlines():
        log(f"  train CLI: {line}")
    launches, built = ws.bucketed_launches, engine.chunk_trace_count()
    other = _counts(fa, wkv, pa)
    applied, recorded = comm_per_step(seen, res.history, n, leaves)
    want_comm = [step_comm * (s + 1) for s in res.history["step"]]
    diffs = [abs(a - b) for a, b in zip(res.history["loss"], phase15["loss"])]
    log(f"training ({arch}, 28 layers, bf16, N={n}, SGD, bucketed WASH "
        f"p=0.01, 2 x {TRAIN_SEQ} tokens per member, {steps} steps, a record "
        f"every {ENGINE_RECORD_EVERY}) through launch.train.main --engine "
        f"shard_map --mesh ens_dp_mp (world 1), every shuffle held against "
        f"its plain version: {wall:.2f} s; chunk functions built {built} "
        f"(expected 1); bucketed shuffle launches {launches} (expected "
        f"{leaves} x {steps}), {counts['bucketed']} of them bitwise equal to "
        f"the plain version, dense {ws.wash_launches}; other kernels' "
        f"launches {other} (expected none); comm per step of the plans "
        f"applied {applied}, recorded {res.history['comm']} at steps "
        f"{res.history['step']} (expected {want_comm}); losses "
        f"{res.history['loss']} against phase 15's {phase15['loss']}: "
        f"|differences| {diffs} (expected 0.0); peak device memory "
        f"{peak:.2f} GiB")
    if "mesh: {'ens': 1, 'data': 1, 'model': 1}" not in printed:
        fail("mesh training: the CLI did not run on the (1, 1, 1) mesh")
    if (launches != leaves * steps or counts["bucketed"] != launches
            or ws.wash_launches or any(other.values())):
        fail(f"mesh training: {launches} bucketed launches "
             f"({counts['bucketed']} checked), {ws.wash_launches} dense, "
             f"other kernels {other}")
    if (applied != [step_comm] * steps or res.history["comm"] != want_comm
            or res.history["comm"] != phase15["comm"]):
        fail(f"mesh training: comm {applied} applied a step, "
             f"{res.history['comm']} recorded, expected {want_comm}")
    if (built != 1 or res.history["step"] != phase15["step"]
            or res.history["loss"] != phase15["loss"]):
        fail(f"mesh training: {built} chunk functions, losses "
             f"{res.history['loss']} at {res.history['step']}, phase 15's "
             f"{phase15['loss']} at {phase15['step']}")
    kernels["bucketed"]["launches"] += launches
    del res, seen
    torch.cuda.empty_cache()
    mesh_layouts()
    log(f"phase 16 (training on ens x data x model meshes, world 1): "
        f"{time.perf_counter() - t0:.1f} s; bucketed launches on the main "
        f"paths so far {kernels['bucketed']['launches']}")


# ---------------------------------------------------------------------------
# phase 17: the pipeline axis in training, at world 1 on the card
# ---------------------------------------------------------------------------

PIPE_MICRO = 2          # (a): microbatches a step (1 x TRAIN_SEQ tokens)
PIPE_PARAM_TOL = 2e-5   # (b): two microbatches against the vmap loop


def pipeline_full_width(torch, device, kernels, phase15) -> None:
    """(a) Full-width llama3.2-3b (bf16, N = 2, SGD, bucketed WASH at
    p = 0.01, 2 x TRAIN_SEQ tokens a member, TRAIN_STEPS steps, a record
    every ENGINE_RECORD_EVERY) through the train CLI's ``main`` with
    ``--engine shard_map --mesh ens_pp --microbatches PIPE_MICRO``: the
    fill is (1, 1), so ``train_population_pipelined`` runs the GPipe
    schedule on one stage, every planned leaf through the bucketed kernel
    (held bitwise against its plain version).  Held to phase 15
    (``phase15``: its history): the comm exactly ``TRAIN_PLANS``' a step,
    one chunk function, losses within ENGINE_LOSS_RTOL; the peak memory
    and the step split.  Adds its bucketed launches to ``kernels``."""
    import io

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.launch import train as train_cli
    from repro_torch.train import engine

    arch, n, steps = "llama3.2-3b", 2, TRAIN_STEPS
    leaves, step_comm = TRAIN_PLANS[arch]
    argv = training_argv(arch, device)
    argv[argv.index("--record-every") + 1] = str(ENGINE_RECORD_EVERY)
    argv += ["--engine", "shard_map", "--mesh", "ens_pp", "--microbatches",
             str(PIPE_MICRO)]
    seen, counts = {"plans": []}, {"dense": 0, "bucketed": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ws.bucketed_launches = ws.wash_launches = 0
    _zero(fa, wkv, pa)
    engine.reset_chunk_trace_count()
    out = io.StringIO()
    t1 = time.perf_counter()
    with checked_shuffles(ops, ref, torch, counts), \
            watch_bucketed_shuffles(ops, 0, seen), \
            contextlib.redirect_stdout(out):
        res = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2**30
    printed = out.getvalue()
    for line in printed.splitlines():
        log(f"  train CLI: {line}")
    launches, built = ws.bucketed_launches, engine.chunk_trace_count()
    other = _counts(fa, wkv, pa)
    applied, recorded = comm_per_step(seen, res.history, n, leaves)
    want_comm = [step_comm * (s + 1) for s in res.history["step"]]
    rel = [abs(a - b) / abs(b)
           for a, b in zip(res.history["loss"], phase15["loss"])]
    split = {p: [round(v, 1) for v in res.phase_ms[p]]
             for p in ("fwd_ticks", "bwd_ticks", "stage_compute", "opt",
                       "mix")}
    log(f"training ({arch}, 28 layers, bf16, N={n}, SGD, bucketed WASH "
        f"p=0.01, 2 x {TRAIN_SEQ} tokens per member in {PIPE_MICRO} "
        f"microbatches, {steps} steps, a record every {ENGINE_RECORD_EVERY})"
        f" through launch.train.main --engine shard_map --mesh ens_pp "
        f"--microbatches {PIPE_MICRO} (world 1), every shuffle held against "
        f"its plain version: {wall:.2f} s; chunk functions built {built} "
        f"(expected 1); bucketed shuffle launches {launches} (expected "
        f"{leaves} x {steps}), {counts['bucketed']} of them bitwise equal to "
        f"the plain version, dense {ws.wash_launches}; other kernels' "
        f"launches {other} (expected none); comm per step of the plans "
        f"applied {applied}, recorded {res.history['comm']} at steps "
        f"{res.history['step']} (expected {want_comm}); losses "
        f"{res.history['loss']} against phase 15's {phase15['loss']}: "
        f"relative differences {rel} (tolerance {ENGINE_LOSS_RTOL:g}); step "
        f"split (CUDA events, ms a step, both members) {split}; peak device "
        f"memory {peak:.2f} GiB")
    if ("mesh: {'ens': 1, 'pipe': 1}" not in printed
            or f"{PIPE_MICRO} microbatch(es) a step" not in printed):
        fail("pipeline training: the CLI did not run on the (1, 1) mesh")
    if (launches != leaves * steps or counts["bucketed"] != launches
            or ws.wash_launches or any(other.values())):
        fail(f"pipeline training: {launches} bucketed launches "
             f"({counts['bucketed']} checked), {ws.wash_launches} dense, "
             f"other kernels {other}")
    if (applied != [step_comm] * steps or res.history["comm"] != want_comm
            or res.history["comm"] != phase15["comm"]):
        fail(f"pipeline training: comm {applied} applied a step, "
             f"{res.history['comm']} recorded, expected {want_comm}")
    if (built != 1 or res.history["step"] != phase15["step"]
            or not np.isfinite(res.history["loss"]).all()
            or max(rel) > ENGINE_LOSS_RTOL):
        fail(f"pipeline training: {built} chunk functions, losses "
             f"{res.history['loss']} at {res.history['step']}, phase 15's "
             f"{phase15['loss']} at {phase15['step']}")
    kernels["bucketed"]["launches"] += launches
    del res, seen
    torch.cuda.empty_cache()


def pipeline_reduced_f32(torch, device) -> None:
    """(b) llama3.2-3b at full width and REDUCED_LAYERS layers in float32,
    REDUCED_STEPS steps through the train CLI (``main(argv, cfg=...)``):
    ``--mesh ens_pp --microbatches 1`` bitwise equal to phase 15's engine
    (``--engine shard_map``: the pipelined engine delegates to it), and
    ``--microbatches 2`` within PIPE_PARAM_TOL of the vmap loop (a mean
    of microbatch means).  PyTorch's deterministic algorithms are on for
    these runs: the embedding's backward otherwise adds with atomics, in
    an order that changes from run to run."""
    import io

    from repro_torch.configs import get_arch
    from repro_torch.core import population as pop
    from repro_torch.launch import train as train_cli

    base = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(base, num_layers=REDUCED_LAYERS, dtype="float32",
                              name=f"{base.name}-{REDUCED_LAYERS}layers-f32")
    argv = training_argv("llama3.2-3b", device)
    argv[argv.index("--steps") + 1] = str(REDUCED_STEPS)
    runs = {"vmap loop": [], "engine": ["--engine", "shard_map"],
            "pipeline, M=1": ["--engine", "shard_map", "--mesh", "ens_pp"],
            "pipeline, M=2": ["--engine", "shard_map", "--mesh", "ens_pp",
                              "--microbatches", "2"]}
    got = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for what, extra in runs.items():
            with contextlib.redirect_stdout(io.StringIO()):
                res = train_cli.main(argv + extra, cfg=cfg)
            torch.cuda.synchronize()
            got[what] = (pop.tree_map(torch.clone, res.population),
                         res.history["loss"])
            del res
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was)

    def diff(a, b) -> float:
        return max(float((x - y).abs().max()) for x, y in zip(
            pop.tree_leaves(a), pop.tree_leaves(b)))

    same = all(torch.equal(x, y) for x, y in zip(
        pop.tree_leaves(got["pipeline, M=1"][0]),
        pop.tree_leaves(got["engine"][0])))
    d = diff(got["pipeline, M=2"][0], got["vmap loop"][0])
    log(f"{cfg.name}, bucketed WASH, SGD, {REDUCED_STEPS} steps through the "
        f"train CLI: --mesh ens_pp --microbatches 1 bitwise equal to the "
        f"engine: {same} (losses {got['pipeline, M=1'][1]} vs "
        f"{got['engine'][1]}); --microbatches 2 against the vmap loop: max "
        f"|param pipeline - loop| = {d:.3e} (tolerance {PIPE_PARAM_TOL:g}; "
        f"losses {got['pipeline, M=2'][1]} vs {got['vmap loop'][1]})")
    if not same or got["pipeline, M=1"][1] != got["engine"][1]:
        fail("reduced f32 pipeline: one microbatch differs from the engine")
    if d > PIPE_PARAM_TOL:
        fail(f"reduced f32 pipeline: two microbatches differ from the loop "
             f"by {d}")
    del got
    torch.cuda.empty_cache()


def pipeline_refuses_stages_past_the_ranks(torch, device) -> None:
    """(c) ``--pp-stages 2`` on one rank is refused before any weight is
    made: the pipe axis must divide the ranks left after the ens axis."""
    from repro_torch.launch import train as train_cli

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        train_cli.main(training_argv("llama3.2-3b", device)
                       + ["--engine", "shard_map", "--mesh", "ens_pp",
                          "--pp-stages", "2"])
    except ValueError as e:
        reason = str(e)
    else:
        fail("two pipeline stages on one card were not refused")
    after = torch.cuda.memory_allocated()
    log(f"--pp-stages 2 on {torch.cuda.device_count()} card: refused: "
        f"{reason}; device memory {before} -> {after} bytes")
    if "pp_stages=2 must divide" not in reason or after != before:
        fail(f"two stages on one card: refused with {reason!r}, memory "
             f"{before} -> {after}")


def pipeline_training(torch, device, kernels, phase15) -> None:
    """Phase 17: the pipelined engine at world 1 on the card: (a) full
    width against phase 15, (b) the reduced f32 cut against the engine
    and the loop, (c) the refusal of two stages on one card."""
    t0 = time.perf_counter()
    pipeline_full_width(torch, device, kernels, phase15)
    pipeline_reduced_f32(torch, device)
    pipeline_refuses_stages_past_the_ranks(torch, device)
    log(f"phase 17 (the pipeline axis in training, world 1): "
        f"{time.perf_counter() - t0:.1f} s; bucketed launches on the main "
        f"paths so far {kernels['bucketed']['launches']}")


# ---------------------------------------------------------------------------
# phase 18: stage-split and data-mesh serving, at world 1 on the card
# ---------------------------------------------------------------------------

VIRTUAL_STAGES = 4  # (b): llama3.2-3b's 28 layers as 4 stages of 7


def mesh_serving_cli(torch, device, card) -> int:
    """(a) Full-width llama3.2-3b (bf16, a random N = 2 population, the
    soup) through the serve CLI's scan engine at phase 8's request shape,
    three times: without a mesh, with ``--mesh data`` (the (1,) data
    group: every row on the one rank) and with ``--pp-stages 1`` (one
    stage: served unstaged).  Each run's tokens must equal the first's,
    and its flash launches be exact (REQUESTS_PER_MODE requests x 28
    layers, nothing else).  Returns the flash launches."""
    import io

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch import serve as serve_cli

    arch, layers = "llama3.2-3b", 28
    argv = ["--arch", arch, "--population", "2", "--seed", "0",
            "--batch-size", str(SCAN_B), "--seq-len", str(SCAN_S),
            "--max-new", str(SCAN_NEW), "--mode", "soup"]
    expect = {"flash": REQUESTS_PER_MODE * layers, "paged": 0, "wkv": 0,
              "ssm": 0}
    runs = {"no mesh": [], "--mesh data": ["--mesh", "data"],
            "--pp-stages 1": ["--pp-stages", "1"]}
    tokens, flash = {}, 0
    for what, extra in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(fa, wkv, pa)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = serve_cli.main(argv + extra)["soup"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _counts(fa, wkv, pa)
        printed = out.getvalue()
        for line in printed.splitlines():
            log(f"  serve CLI {what}: {line}")
        tokens[what] = res["tokens"]
        log(f"serve CLI {what} ({arch}, full width, bf16, N=2 soup, B="
            f"{SCAN_B}, S={SCAN_S}, {SCAN_NEW} new): {dt:.2f} s with the "
            f"population's init; kernel launches {counts} (expected "
            f"{expect}); prefill {res['prefill_s']:.3f} s, decode step "
            f"{res['decode_step_ms']:.2f} ms, {res['tok_s']:.2f} tok/s; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; tokens "
            f"equal the run without a mesh: "
            f"{torch.equal(res['tokens'], tokens['no mesh'])} on {card}")
        if counts != expect:
            fail(f"mesh serving {what}: kernel launches {counts}, expected "
                 f"{expect}")
        if not torch.equal(res["tokens"], tokens["no mesh"]):
            fail(f"mesh serving {what}: tokens differ from the run without "
                 f"a mesh")
        mesh_line = {"--mesh data": "mesh: {'data': 1}",
                     "--pp-stages 1": "mesh: {'pipe': 1}"}.get(what)
        if mesh_line is not None and mesh_line not in printed:
            fail(f"mesh serving {what}: the CLI printed no {mesh_line!r}")
        flash += counts["flash"]
        del res
        torch.cuda.empty_cache()
    return flash


def virtual_stages(torch, device, card) -> None:
    """(b) The stage functions composed over VIRTUAL_STAGES slices of
    full-width llama3.2-3b's blocks (7 layers each, a cache each) on the
    one card, held bitwise to the unstaged engine on the soup of a random
    N = 2 population: the prefill's logits (``M.prefill``, with exactly
    28 flash launches on either side) and SCAN_NEW - 1 greedy decode
    steps' tokens (``engine.generate``)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import averaging
    from repro_torch.core import population as pop
    from repro_torch.core.prng import fold_in
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.launch.serve import init_population
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import transformer as M
    from repro_torch.serving import engine

    cfg = get_arch("llama3.2-3b")
    n = cfg.num_layers // VIRTUAL_STAGES
    local = dataclasses.replace(cfg, num_layers=n)
    soup = averaging.uniform_soup_(init_population(cfg, 2, 0, device))
    batch = concrete_batch(cfg, fold_in(0, 2), SCAN_B, SCAN_S, device=device)
    cap = SCAN_S + SCAN_NEW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        _zero(fa, wkv, pa)
        want_logits, _ = M.prefill(soup, cfg, batch, capacity=cap)
        unstaged = _counts(fa, wkv, pa)
        want = engine.generate(soup, cfg, batch, SCAN_NEW, device=device)
        _zero(fa, wkv, pa)
        t0 = time.perf_counter()
        blocks = [pop.tree_map(lambda x: x[s * n:(s + 1) * n],
                               soup["blocks"]) for s in range(VIRTUAL_STAGES)]
        caches = [M.init_cache(local, SCAN_B, cap, device=device)
                  for _ in range(VIRTUAL_STAGES)]
        h = M.prefill_embed(soup, cfg, batch)
        for s in range(VIRTUAL_STAGES):
            h, caches[s] = M.prefill_blocks(blocks[s], local, h, caches[s])
        logits = M.lm_logits(soup, cfg, h[:, -1:])
        staged = _counts(fa, wkv, pa)
        toks = [logits[:, -1].argmax(-1).to(torch.int32)]
        for i in range(SCAN_NEW - 1):
            h = M.decode_embed(soup, cfg, toks[-1][:, None], SCAN_S + i)
            for s in range(VIRTUAL_STAGES):
                h, caches[s] = M.decode_blocks(blocks[s], local, h,
                                               caches[s], SCAN_S + i)
            toks.append(M.lm_logits(soup, cfg, h)[:, -1].argmax(-1).to(
                torch.int32))
        got = torch.stack(toks, dim=1)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    same_logits = torch.equal(logits, want_logits)
    same_tokens = torch.equal(got, want[:, SCAN_S:])
    log(f"virtual stages (llama3.2-3b, full width, bf16, the soup of N=2, "
        f"{VIRTUAL_STAGES} stages of {n} layers on the one card, B={SCAN_B}, "
        f"S={SCAN_S}, {SCAN_NEW} greedy tokens): {dt:.2f} s; prefill logits "
        f"bitwise equal to the unstaged prefill: {same_logits}; tokens "
        f"bitwise equal to engine.generate's: {same_tokens}; flash launches "
        f"{staged['flash']} staged, {unstaged['flash']} unstaged a prefill "
        f"(expected {cfg.num_layers}); other kernels {staged}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
        f"{card}")
    if not (same_logits and same_tokens):
        fail("virtual stages: the staged prefill or tokens differ from the "
             "unstaged engine")
    expect = {"flash": cfg.num_layers, "paged": 0, "wkv": 0, "ssm": 0}
    if staged != expect or unstaged != expect:
        fail(f"virtual stages: launches {staged} staged, {unstaged} "
             f"unstaged, expected {expect}")
    del soup, caches, blocks
    torch.cuda.empty_cache()


def serve_refuses_stages_past_the_ranks(torch, device) -> None:
    """(c) The serve CLI's ``--pp-stages 2`` on one rank is refused before
    any weight is made: a stage a rank, and the world is one."""
    import io

    from repro_torch.launch import serve as serve_cli

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            serve_cli.main(["--arch", "llama3.2-3b", "--population", "2",
                            "--pp-stages", "2"])
    except SystemExit as e:
        code = e.code
    else:
        fail("the serve CLI's --pp-stages 2 on one card was not refused")
    after = torch.cuda.memory_allocated()
    reason = err.getvalue().strip().splitlines()[-1]
    log(f"serve CLI --pp-stages 2 on {torch.cuda.device_count()} card: "
        f"refused (exit {code}): {reason}; device memory {before} -> "
        f"{after} bytes")
    if "needs that many ranks" not in reason or after != before:
        fail(f"serve --pp-stages 2 on one card: refused with {reason!r}, "
             f"memory {before} -> {after}")


def mesh_serving(torch, device, kernels, card) -> None:
    """Phase 18: stage-split and data-mesh serving at world 1 on the card:
    (a) the serve CLI on the (1,) data mesh and one stage against no mesh,
    (b) four virtual stages against the unstaged engine, (c) the refusal
    of two stages on one card."""
    t0 = time.perf_counter()
    kernels["flash_bf16"]["launches"] += mesh_serving_cli(torch, device,
                                                          card)
    virtual_stages(torch, device, card)
    serve_refuses_stages_past_the_ranks(torch, device)
    log(f"phase 18 (stage-split and data-mesh serving, world 1): "
        f"{time.perf_counter() - t0:.1f} s; flash bf16 launches on the main "
        f"paths so far {kernels['flash_bf16']['launches']}")


# ---------------------------------------------------------------------------
# phase 19: the dry run and the analysis lane on the card
# ---------------------------------------------------------------------------

def dry_run_predictions(torch, device, phase5) -> None:
    """(a) The dry run (``launch/dryrun.py``, meta tensors only) predicts
    the per-card peak of phases 5, 8 and 15 at full width; each is
    printed beside the peak that phase measured, and
    ``torch.cuda.memory_allocated()`` must not move across the dry run."""
    from repro_torch.configs import get_arch
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.launch import dryrun

    cfg = get_arch("llama3.2-3b")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    train = dryrun.account_train(
        cfg, 2, TRAIN_SEQ, {"ens": 1}, 2,
        MixingConfig(kind="wash", base_p=0.01, mode="bucketed"), "sgd")
    scan = dryrun.account_request(cfg, SCAN_B, SCAN_S, SCAN_NEW, members=2,
                                  held_models=3)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    log(f"dry run (meta tensors): {dt:.2f} s; memory_allocated {before} B "
        f"before, {after} B after")
    if after != before:
        fail(f"the dry run moved memory_allocated: {before} -> {after} B")
    gib = 2 ** 30
    rows = [("phase 5 (llama3.2-3b, bf16, N=2, SGD, 2 x 256, the loop)",
             train, phase5["timing"]["peak_gib"]),
            ("phase 8 (llama3.2-3b scan request, B=4 x 2048, 32 new, N=2 "
             "and its soup held, the ensemble's two caches)", scan,
             PEAK_GIB.get("scan llama3.2-3b")),
            ("phase 15 (the same run through the engine at world 1)", train,
             PEAK_GIB.get("engine"))]
    for what, acc, measured in rows:
        c = acc["counter"]
        predicted = (acc["resident"] + c.peak_bytes) / gib
        rel = (None if measured is None
               else abs(predicted - measured) / measured)
        log(f"dry run {what}: predicted per-card peak {predicted:.2f} GiB "
            f"(resident {acc['resident'] / gib:.2f} + step "
            f"{c.peak_bytes / gib:.2f}; {c.flops / 1e12:.3f} TFLOP, "
            f"{c.bytes / 1e9:.1f} GB through aten ops and kernels); "
            f"measured {measured if measured is None else round(measured, 2)}"
            f" GiB; |predicted - measured| / measured "
            f"{rel if rel is None else round(rel, 4)}")


def serving_contracts_on_card(torch, device) -> None:
    """(b) The three serving entries of the contract matrix on the card,
    with their host syncs per decode step; then the syncs per decode step
    of phase 8's llama3.2-3b request (the soup, B=4 x 2048, 32 new), by
    call site."""
    from repro_torch.analysis import matrix
    from repro_torch.configs import get_arch
    from repro_torch.launch.specs import concrete_batch
    from repro_torch.models import transformer as M

    results = matrix.run_matrix(("scan_decode", "continuous_decode",
                                 "speculative_decode"), device=device)
    for name, r in results.items():
        syncs = r["syncs"]
        log(f"contract {name} on the card: OK, {r['compiles']} programs, "
            f"{len(r['reports'])} calls checked; host syncs per decode step "
            f"{syncs['per_decode_step']:g} over {syncs['decode_steps']} "
            f"steps: {dict(syncs['sites'])}")
    cfg = get_arch("llama3.2-3b")
    params = M.init_params(cfg, seed=0, device=device)
    batch = concrete_batch(cfg, 2, SCAN_B, SCAN_S, device=device)
    reading = matrix.request_syncs(params, cfg, batch, SCAN_NEW, device)
    del params
    torch.cuda.empty_cache()
    log(f"phase 8's llama3.2-3b request (soup, B={SCAN_B} x {SCAN_S}, "
        f"{SCAN_NEW} new): host syncs per decode step "
        f"{reading['per_decode_step']:g} ({cfg.num_layers} layers; "
        f"{reading['decode_steps']} decode steps), by call site "
        f"{dict(reading['sites'])}")


def lint_lane() -> None:
    """(c) The lints over src/repro_torch, modulo the checked baseline."""
    from repro_torch.analysis import __main__ as runner

    if runner.run_lints(ROOT, runner.BASELINE) != 0:
        fail("the lint lane found violations or stale waivers")


def dry_run_and_analysis(torch, device, phase5) -> None:
    """Phase 19: the dry run's predictions against phases 5, 8 and 15,
    the serving contracts on the card, the lints."""
    t0 = time.perf_counter()
    dry_run_predictions(torch, device, phase5)
    serving_contracts_on_card(torch, device)
    lint_lane()
    log(f"phase 19 (the dry run and the analysis lane): "
        f"{time.perf_counter() - t0:.1f} s")


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
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.kernels import wash_shuffle as ws

    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels(pa, ws, fa, wkv, ssk)

    kernels = check_kernel(torch, pa, ref, F, device)
    full_width(torch, device, kernels)
    reduced_f32(torch, device, kernels)
    shuffles = check_shuffle_kernels(torch, device)
    phase5 = train_full_width(torch, device, "llama3.2-3b", shuffles)
    reduced_paths(torch, device, shuffles)
    kernels.update(shuffles)
    kernels.update(check_flash(torch, fa, ref, F, device))
    kernels.update(check_wkv(torch, wkv, ref, device))
    kernels.update(check_wkv_backward(torch, wkv, ref, device))
    scan_engine(torch, device, kernels, card)
    train_full_width(torch, device, "rwkv6-3b", kernels)
    train_rwkv6_reduced(torch, device)
    image_classification(torch, device, kernels, card)
    live_traffic(torch, device, kernels, card)
    kernels.update(check_flash_mla(torch, fa, ref, F, device))
    moe_and_mla(torch, device, kernels, card)
    hybrid_family(torch, F, device, kernels, card)
    last_families(torch, F, device, kernels, card)
    phase15 = multi_device_training(torch, device, kernels, phase5)
    multi_axis_training(torch, device, kernels, phase15)
    pipeline_training(torch, device, kernels, phase15)
    mesh_serving(torch, device, kernels, card)
    dry_run_and_analysis(torch, device, phase5)
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
