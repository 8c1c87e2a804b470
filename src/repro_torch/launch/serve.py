"""CLI launcher: serve a WASH population (scan engine or continuous batching).

Port of ``repro/launch/serve.py``.  Loads a population (random-init from
``--seed``, ``--ckpt``, a stacked population ``.npz`` written by either
package's ``train.checkpoint.save``, for example the JAX train CLI's
``--ckpt-population``, or quick-trained ``--train-steps`` steps), turns it
into the ``--mode``'s serving params, and serves it through one of three
runtimes:

  * default — the scan engine (``serving.engine.generate``): a
    shape-uniform batch of ``--batch-size`` prompts of ``--seq-len``
    tokens, prefilled at once and decoded ``--max-new`` tokens, reporting
    tokens/s; ``--compare`` serves the same batch in every mode.  On the
    card every prefill attention runs the hand-written flash-attention
    kernel, every rwkv6 time mix the hand-written WKV kernel and every
    hybrid (hymba) layer's Mamba recurrence the hand-written
    selective-scan kernel, in prefill and in each decode step;
  * ``--continuous`` — a mixed-length request stream through
    ``serving.batching.ContinuousServer`` over a paged KV cache, reporting
    tokens/s and the runtime's page accounting; every decode attend runs
    the hand-written paged-attention kernel (``--speculative``: the soup
    drafts ``--draft-k`` tokens, the ensemble verifies them in one step);
  * ``--driver`` — the request driver (``serving.driver``) over the same
    runtime: Poisson arrivals (``--arrival-rate``), chunked prefill
    interleaved with decode (``--prefill-chunk``), LRU page retention
    (``--retain-pages``), reporting TTFT p50/p99, inter-token p99, latency
    p99 and tokens/s.

The scan engine also serves across ranks (``torchrun``; NCCL on the
card, one card a rank; gloo with ``--device cpu``): ``--mesh data`` gives
every rank the whole population and its rows of the batch (the output
gathered in order), ``--pp-stages S`` splits the blocks over S ranks, each
holding (and restoring from ``--ckpt``) only its stage's layers.  Rank 0
prints.  Both are refused with ``--continuous`` and ``--driver``, and
``--pp-stages`` with ``--mesh``, with a world other than S, and with
``--train-steps``, before any weight is made.

  torchrun --standalone --nproc-per-node=4 -m repro_torch.launch.serve \\
      --arch llama3.2-3b --population 2 --batch-size 4 --seq-len 2048 \\
      --max-new 32 --pp-stages 4

``--metrics-out`` writes the telemetry event stream (``repro_torch.obs``)
as JSONL, which ``tools/check_metrics_schema.py`` checks;
``--metrics-summary`` prints the metrics at exit; ``--profile-dir`` writes
a Chrome trace of the first instrumented spans.

  python -m repro_torch.launch.serve --arch rwkv6-3b --population 2 \\
      --batch-size 4 --seq-len 2048 --max-new 32 --compare

  python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
      --population 2 --batch-size 4 --seq-len 2048 --max-new 32 --compare

  python -m repro_torch.launch.serve --arch hymba-1.5b --population 2 \\
      --batch-size 4 --seq-len 2048 --max-new 32 --compare

(``--compare`` serves member and ensemble first and the soup last, made
in place from the population's memory, so a 16B N=2 population fits one
80 GB card.)

  python -m repro_torch.launch.serve --arch llama3.2-3b --reduced \\
      --device cpu --mode ensemble --temperature 0.7 --seed 3

  python -m repro_torch.launch.serve --arch llama3.2-3b --continuous \\
      --population 2 --requests 16 --max-slots 8 --seq-len 512 --max-new 32

  python -m repro_torch.launch.serve --arch llama3.2-3b --driver \\
      --population 2 --arrival-rate 2 --prefill-chunk 256 --retain-pages \\
      --speculative --seq-len 512 --metrics-out build/serve.jsonl
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import averaging
from repro_torch.core import population as pop
from repro_torch.core.device import resolve_device
from repro_torch.core.mixing import MixingConfig
from repro_torch.core.prng import fold_in
from repro_torch.kernels import (flash_attention, paged_attention, rwkv6_scan,
                                 selective_scan)
from repro_torch.launch.mesh import (host_world, make_host_data_mesh,
                                     make_host_pipe_mesh)
from repro_torch.launch.specs import concrete_batch
from repro_torch.models import transformer as M
from repro_torch.serving import batching
from repro_torch.serving import engine as serving
from repro_torch.serving.driver import (RequestDriver, poisson_arrivals,
                                        summarize)
from repro_torch.train import checkpoint
from repro_torch.train.loop import train_population


def _member_shapes(cfg, mesh=None):
    """A member's ``param_shapes``; on a pipe ``mesh``, this rank's stage
    of them."""
    shapes = M.param_shapes(cfg)
    return shapes if mesh is None else serving.stage_params(shapes, cfg,
                                                            mesh)


def init_population(cfg, n: int, seed: int, device, mesh=None):
    """N independently initialized members, stacked: member i is
    ``M.init_params(cfg, seed=seed * 1000 + i)``, drawn straight into its
    slot of the stacked leaves (no member is built whole beside them).
    On a pipe ``mesh`` the population holds this rank's stage of each
    member (``engine.stage_params``): each member is drawn whole, its
    stage kept, the rest freed."""
    dev = resolve_device(device)
    popn = pop.tree_map(
        lambda m: torch.empty((n,) + tuple(m.shape), dtype=m.dtype,
                              device=dev), _member_shapes(cfg, mesh))
    for i in range(n):
        if mesh is None:
            M.init_params(cfg, seed=seed * 1000 + i, device=dev,
                          out=pop.member(popn, i))
            continue
        whole = M.init_params(cfg, seed=seed * 1000 + i, device=dev)
        pop.tree_map(lambda d, x: d.copy_(x), pop.member(popn, i),
                     serving.stage_params(whole, cfg, mesh))
        del whole
    return popn


def _population(args, cfg, device, mesh=None, lead=True):
    """The population to serve: restored, quick-trained or drawn; on a
    pipe ``mesh`` only this rank's stage of it."""
    if args.ckpt:
        like = pop.tree_map(
            lambda x: x.unsqueeze(0).expand((args.population,) + x.shape),
            _member_shapes(cfg, mesh))
        popn = checkpoint.restore(
            args.ckpt, like, device=device,
            stage=None if mesh is None else (mesh.stage, mesh.num_stages))
        if lead:
            print(f"restored population <- {args.ckpt}")
        return popn
    if args.train_steps > 0:
        return _quick_train(cfg, args, device)
    return init_population(cfg, args.population, args.seed, device, mesh)


def _quick_train(cfg, args, device):
    """``--train-steps`` steps of bucketed WASH (p = 0.05, SGD, 8 x 32
    tokens a member on the synthetic LM task), the JAX CLI's quick-train."""
    from repro_torch.data import make_lm_task, sample_tokens

    task = make_lm_task(fold_in(args.seed, 1),
                        vocab=min(cfg.vocab_size, 512), device=device)

    def data_fn(m, step, seed):
        b = concrete_batch(cfg, fold_in(seed, 10), 8, 32, device=device)
        b["tokens"] = sample_tokens(task, seed, 8, 32) % cfg.vocab_size
        return b

    def loss_fn(params, batch):
        loss, _ = M.loss_fn(params, cfg, batch)
        return loss

    res = train_population(
        args.seed, lambda s: M.init_params(cfg, seed=s, device=device),
        loss_fn, data_fn,
        TrainConfig(population=args.population, optimizer="sgd", lr=0.05,
                    total_steps=args.train_steps),
        MixingConfig(kind="wash", base_p=0.05, mode="bucketed"),
        cfg.num_layers, record_every=max(args.train_steps // 2, 1),
        device=device)
    print(f"quick-trained {args.train_steps} steps: loss "
          f"{res.history['loss'][-1]:.4f}")
    return res.population


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_once(popn, cfg, batch, args, mode, sample_seed, device,
                mesh=None):
    """Serve ``batch`` in ``mode`` through the scan engine twice: the first
    request builds the programs (and the kernels, on a fresh card), the
    second is timed.  Resolves the mode's params once (soup averaging and
    member slicing are per-deployment work); the soup is made in place
    (``averaging.uniform_soup_``), so it spends the population.  Returns
    ``{"tokens", "tok_s", "first_s", "steady_s", "prefill_s",
    "decode_step_ms"}``: the timed request's tokens, tok/s and seconds,
    the first request's seconds, and the timed request's prefill seconds
    and mean decode-step milliseconds (``serving.generate``'s
    ``timings``, each timed to the device's end; on a mesh, this rank's,
    and rank 0 prints)."""
    params = (averaging.uniform_soup_(popn) if mode == "soup" else
              serving.serving_params(popn, mode, args.member))
    gen_mode = "ensemble" if mode == "ensemble" else "soup"

    def request(timings=None):
        out = serving.generate(params, cfg, batch, args.max_new,
                               temperature=args.temperature, seed=sample_seed,
                               mode=gen_mode, device=device, timings=timings,
                               mesh=mesh)
        _sync(device)
        return out

    t0 = time.perf_counter()
    request()
    first = time.perf_counter() - t0
    split = {}
    t0 = time.perf_counter()
    out = request(split)
    dt = max(time.perf_counter() - t0, 1e-9)
    toks = args.batch_size * args.max_new
    step_ms = split["decode_s"] * 1e3 / max(args.max_new - 1, 1)
    if mesh is None or mesh.rank == 0:
        print(f"mode={mode:9s} {toks / dt:9.1f} tok/s  (first request "
              f"{first:.2f}s, steady {dt:.3f}s/req: prefill "
              f"{split['prefill_s']:.3f}s, decode step {step_ms:.1f}ms; "
              f"decode programs {serving.decode_trace_count()}, programs "
              f"cached {serving.executable_cache_size()}, device={device})")
    return {"tokens": out, "tok_s": toks / dt, "first_s": first,
            "steady_s": dt, "prefill_s": split["prefill_s"],
            "decode_step_ms": step_ms}


def _serve_scan(popn, cfg, args, device, mesh=None):
    """The default runtime: one shape-uniform batch through the scan
    engine in ``--mode`` (every mode with ``--compare``), on ``mesh``
    when given (rank 0 prints)."""
    lead = mesh is None or mesh.rank == 0
    batch = concrete_batch(cfg, fold_in(args.seed, 2), args.batch_size,
                           args.seq_len, device=device)
    sample_seed = fold_in(args.seed, 999) if args.temperature > 0.0 else None
    if lead and mesh is not None:
        print(f"mesh: {dict(mesh.shape)}")
        if "data" in mesh.axis_names:
            layout = serving.data_layout(cfg, mesh, args.batch_size)
            rows = (args.batch_size // mesh.data.world if layout == "split"
                    else args.batch_size)
            print(f"batch {layout} over the data group: {rows} rows a rank")
    if lead:
        print(f"arch={cfg.name} population={args.population} "
              f"B={args.batch_size} S={args.seq_len} new={args.max_new} "
              f"temperature={args.temperature}")
    serving.reset_trace_counts()
    # the soup last: it is made in place, from the population's memory
    modes = ["member", "ensemble", "soup"] if args.compare else [args.mode]
    launches0 = (flash_attention.launches, rwkv6_scan.launches,
                 selective_scan.launches)
    outs = {m: _serve_once(popn, cfg, batch, args, m, sample_seed, device,
                           mesh)
            for m in modes}
    if lead:
        print(f"kernel launches: flash attention "
              f"{flash_attention.launches - launches0[0]}, rwkv6 scan "
              f"{rwkv6_scan.launches - launches0[1]}, selective scan "
              f"{selective_scan.launches - launches0[2]}")
    if args.compare and lead:
        soup = outs["soup"]["tokens"][:, args.seq_len:]
        ens = outs["ensemble"]["tokens"][:, args.seq_len:]
        agree = float((soup == ens).float().mean())
        print(f"soup/ensemble token agreement: {agree:.0%}")
    return outs


def mixed_stream(cfg, n_requests: int, max_prompt: int, max_new: int,
                 seed: int, temperature: float = 0.0,
                 share_prefix_every: int = 0):
    """A synthetic mixed-length request stream: prompt lengths and token
    budgets drawn uniformly from ``seed``, the same stream as the JAX
    package's ``mixed_stream`` for the same arguments.

    ``share_prefix_every=k`` makes every k-th request reuse one common
    prompt prefix, so prefix-page dedup has something to find.  Requests
    carry a per-request ``seed`` when sampling."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, cfg.vocab_size, size=(max_prompt,)).astype(np.int32)
    reqs = []
    for i in range(n_requests):
        S = int(rng.integers(max(2, max_prompt // 4), max_prompt + 1))
        mn = int(rng.integers(max(1, max_new // 4), max_new + 1))
        if share_prefix_every and i % share_prefix_every == 0:
            prompt = common[:S].copy()
        else:
            prompt = rng.integers(0, cfg.vocab_size, size=(S,)).astype(np.int32)
        req_seed = 1000 + i if temperature > 0 else None
        reqs.append(batching.Request(i, prompt, mn, seed=req_seed))
    return reqs


def _serve_continuous(popn, cfg, args, device):
    # page-table width = the stream's worst-case context, not the whole pool
    max_pages = -(-(args.seq_len + args.max_new) // args.page_size)
    server = batching.ContinuousServer.from_trained(
        popn, cfg, mode=args.mode, member=args.member,
        temperature=args.temperature, page_size=args.page_size,
        max_slots=args.max_slots, num_pages=args.num_pages,
        max_pages_per_slot=max_pages, speculative=args.speculative,
        draft_k=args.draft_k, kv_dtype=args.kv_dtype, device=device,
    )
    reqs = mixed_stream(cfg, args.requests, args.seq_len, args.max_new,
                        args.seed, args.temperature)
    batching.reset_trace_counts()
    launches0 = paged_attention.launches
    _sync(device)
    t0 = time.perf_counter()
    out = server.run(reqs)
    _sync(device)
    dt = max(time.perf_counter() - t0, 1e-9)
    toks = sum(r.max_new for r in reqs)
    st = server.stats
    print(f"continuous mode={args.mode} requests={len(reqs)} "
          f"slots={args.max_slots} page_size={args.page_size} "
          f"pool={args.num_pages} kv_dtype={args.kv_dtype or 'param'} "
          f"device={device}")
    print(f"  {toks / dt:9.1f} tok/s  ({dt:.2f}s stream, "
          f"{st['decode_steps']} decode steps, kernel launches "
          f"{paged_attention.launches - launches0})")
    print(f"  pages: allocated {st['pages_allocated']}, "
          f"shared {st['pages_shared']}, peak {st['peak_pages_in_use']}; "
          f"decode programs {batching.decode_trace_count()}, prefill "
          f"programs {batching.prefill_trace_count()}")
    _print_speculative(args, st)
    if len(out) != len(reqs):
        raise RuntimeError(f"served {len(out)} of {len(reqs)} requests")
    return out


def _print_speculative(args, st) -> None:
    if args.speculative:
        drafted = max(st["spec_drafted"], 1)
        print(f"  speculative draft_k={args.draft_k}: accepted "
              f"{st['spec_accepted']}/{st['spec_drafted']} drafts "
              f"({st['spec_accepted'] / drafted:.0%})")


def _serve_driver(popn, cfg, args, device):
    """Serve the mixed stream (every 4th request on a shared prefix)
    through the request driver: Poisson (or back-to-back) arrivals,
    chunked prefill interleaved with decode, and the SLO view of the run
    (``driver.summarize``).  Returns ``(metrics, summary)``."""
    max_pages = -(-(args.seq_len + args.max_new) // args.page_size)
    server = batching.ContinuousServer.from_trained(
        popn, cfg, mode=args.mode, member=args.member,
        temperature=args.temperature, page_size=args.page_size,
        max_slots=args.max_slots, num_pages=args.num_pages,
        max_pages_per_slot=max_pages, retain_pages=args.retain_pages,
        speculative=args.speculative, draft_k=args.draft_k,
        kv_dtype=args.kv_dtype, device=device,
    )
    reqs = mixed_stream(cfg, args.requests, args.seq_len, args.max_new,
                        args.seed, args.temperature, share_prefix_every=4)
    chunk = args.prefill_chunk if args.prefill_chunk > 0 else None
    driver = RequestDriver(server, prefill_chunk=chunk)
    arrivals = (poisson_arrivals(reqs, args.arrival_rate, seed=args.seed)
                if args.arrival_rate > 0 else reqs)
    batching.reset_trace_counts()
    launches0 = paged_attention.launches
    metrics = driver.run(arrivals)
    _sync(device)
    s = summarize(metrics)
    st = server.stats

    def ms(v, digits):
        return "n/a" if v is None else f"{v:.{digits}f}ms"

    print(f"driver mode={args.mode} requests={s['requests']} "
          f"slots={args.max_slots} chunk={chunk} "
          f"arrival_rate={args.arrival_rate or 'back-to-back'} "
          f"device={device}")
    print(f"  {s['tokens_per_s'] or 0.0:9.1f} tok/s  "
          f"ttft p50 {ms(s['ttft_p50_ms'], 1)} "
          f"p99 {ms(s['ttft_p99_ms'], 1)}  "
          f"intertoken p99 {ms(s['intertoken_p99_ms'], 2)}  "
          f"latency p99 {ms(s['latency_p99_ms'], 1)}")
    print(f"  decode programs {batching.decode_trace_count()}, prefill "
          f"programs {batching.prefill_trace_count()}, prefill tokens "
          f"{st['prefill_tokens']} (prefix reused "
          f"{st['prefix_tokens_reused']}), lru hits {st['lru_hits']} "
          f"evictions {st['lru_evictions']}, decode steps "
          f"{st['decode_steps']}, kernel launches "
          f"{paged_attention.launches - launches0}")
    _print_speculative(args, st)
    if s["requests"] != len(reqs):
        raise RuntimeError(f"served {s['requests']} of {len(reqs)} requests")
    # one decode program serves the whole stream
    if batching.decode_trace_count() > 1:
        raise RuntimeError(f"{batching.decode_trace_count()} decode programs "
                           "for one pool geometry")
    return metrics, s


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    ap.add_argument("--arch", required=True,
                    help="architecture name from repro_torch.configs (e.g. "
                         "llama3.2-3b)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced (small, float32) config variant")
    ap.add_argument("--population", type=int, default=4,
                    help="population size N (members to init/restore)")
    ap.add_argument("--mode", default="soup", choices=list(serving.MODES),
                    help="serving mode: soup (1x cost), member (one member), "
                         "ensemble (Nx decode, averaged logits)")
    ap.add_argument("--member", type=int, default=0,
                    help="which member --mode member serves")
    ap.add_argument("--mesh", default="none", choices=["none", "data"],
                    help="data: every rank (torchrun) holds the whole "
                         "population and serves its rows of the batch "
                         "(launch.mesh.make_host_data_mesh); scan engine "
                         "only")
    ap.add_argument("--pp-stages", type=int, default=0,
                    help="stage-split serving over this many pipeline "
                         "stages, one rank each (torchrun with as many "
                         "ranks): each rank holds L/S of the blocks and of "
                         "the KV cache, the tokens are the unstaged "
                         "engine's; scan engine only, attention families, "
                         "num_layers %% S == 0")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy")
    ap.add_argument("--max-new", type=int, default=32,
                    help="new tokens per request (continuous: the maximum "
                         "of the per-request budget range)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="scan engine: prompts in the shape-uniform batch")
    ap.add_argument("--seq-len", type=int, default=32,
                    help="prompt length (continuous: the maximum of the "
                         "per-request prompt-length range)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for weights, prompts, stream shape, and (scan "
                         "engine, --temperature > 0) the sample streams")
    ap.add_argument("--ckpt", default=None,
                    help="restore a stacked-population .npz (for example "
                         "from the JAX train CLI's --ckpt-population)")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="quick-train the population this many steps first "
                         "(bucketed WASH; ignored with --ckpt)")
    ap.add_argument("--compare", action="store_true",
                    help="scan engine: serve the same batch in every mode "
                         "and report the soup/ensemble token agreement")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a mixed-length request stream through the "
                         "continuous-batching paged-KV runtime instead of "
                         "the scan engine")
    ap.add_argument("--requests", type=int, default=16,
                    help="continuous: number of requests in the stream")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="continuous: in-flight request slots (the decode "
                         "step's batch)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="continuous: tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=256,
                    help="continuous: KV page-pool size shared by all slots")
    ap.add_argument("--kv-dtype", default=None, choices=["int8"],
                    help="continuous/driver: quantize the paged KV pools to "
                         "int8, one scale per (layer, page) (default: the "
                         "model's param dtype)")
    ap.add_argument("--driver", action="store_true",
                    help="serve the stream through the request driver "
                         "(timed arrivals, chunked prefill interleaved with "
                         "decode, TTFT/latency percentiles)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="driver: Poisson arrival rate in requests/s "
                         "(0 = submit the whole stream back-to-back)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="driver: prefill at most this many prompt tokens "
                         "per tick, interleaved with decode steps "
                         "(0 = the whole remaining suffix at once)")
    ap.add_argument("--retain-pages", action="store_true",
                    help="driver: keep refcount-0 prefix pages on an LRU "
                         "list (evicted only under pool pressure) so "
                         "recurring prompts skip their prefill")
    ap.add_argument("--speculative", action="store_true",
                    help="continuous/driver: the soup drafts --draft-k "
                         "tokens per step, the ensemble verifies them in "
                         "one step (the plain path's tokens at float32 KV)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative draft length (tokens proposed per "
                         "decode call)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the telemetry event stream (spans, program "
                         "builds, SLO histograms, final metric snapshots) "
                         "as JSONL here; check it with "
                         "tools/check_metrics_schema.py")
    ap.add_argument("--metrics-summary", action="store_true",
                    help="print a telemetry metric summary on exit")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of the first "
                         "instrumented spans into this directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on: cuda (the default; "
                         "raises without a card) or cpu")
    return ap


def main(argv=None, cfg=None):
    """Serve as the flags say.  Returns what the runtime served: the
    driver's ``(metrics, summary)``, the continuous server's results, or
    per mode the scan engine's tokens and timings.  ``cfg``, when given,
    is served in place of ``--arch``'s config (a caller's depth cut,
    which no flag expresses, as the train CLI's ``main`` takes one)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    paged = args.continuous or args.driver
    if paged and args.compare:
        ap.error("--compare is a scan-engine option; drop "
                 "--continuous/--driver")
    if (args.speculative or args.kv_dtype) and not paged:
        ap.error("--speculative/--kv-dtype are continuous-runtime knobs; "
                 "add --continuous or --driver")
    if args.draft_k < 1:
        ap.error("--draft-k must be >= 1")
    meshed = args.mesh != "none" or args.pp_stages
    if meshed and paged:
        ap.error(f"--{'driver' if args.driver else 'continuous'} does not "
                 "take --mesh/--pp-stages (single-host runtime)")
    if args.pp_stages and args.mesh != "none":
        ap.error("--pp-stages builds its own (pipe,) mesh; drop --mesh")
    if meshed and args.train_steps > 0 and not args.ckpt:
        ap.error("--train-steps does not take --mesh/--pp-stages: train "
                 "with the train CLI's --ckpt-population and serve --ckpt")
    if args.pp_stages:
        world = host_world()
        if args.pp_stages < 1 or args.pp_stages != world:
            ap.error(f"--pp-stages {args.pp_stages} needs that many ranks, "
                     f"one a stage (torchrun --nproc-per-node="
                     f"{args.pp_stages}); the world has {world}")
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if device.type == "cuda":  # before any weight reaches the card
        path = "continuous" if paged else "scan"
        reason = M.cuda_supported(cfg, path)
        if reason is not None:
            raise NotImplementedError(f"serving {cfg.name} on the card "
                                      f"({path}): {reason}")
        if args.train_steps > 0 and not args.ckpt:
            reason = M.cuda_supported(cfg, "train")
            if reason is not None:
                raise NotImplementedError(
                    f"quick-training {cfg.name} on the card: {reason}")
    mesh = None
    if args.pp_stages:
        mesh = make_host_pipe_mesh(args.pp_stages, device)
    elif args.mesh == "data":
        mesh = make_host_data_mesh(device)
    lead = mesh is None or mesh.rank == 0
    try:
        if mesh is not None:
            device = mesh.device
            if mesh.num_stages > 1:  # the reference's refusals, up front
                serving.check_staged_request(cfg, args.mode, mesh)
        tel = obs.configure(jsonl=args.metrics_out if lead else None,
                            console=args.metrics_summary and lead,
                            profile_dir=args.profile_dir if lead else None)
        try:
            staged = mesh if mesh is not None and mesh.num_stages > 1 else None
            popn = _population(args, cfg, device, staged, lead)
            if args.driver:
                return _serve_driver(popn, cfg, args, device)
            if args.continuous:
                return _serve_continuous(popn, cfg, args, device)
            return _serve_scan(popn, cfg, args, device, mesh)
        finally:
            tel.finalize()
            if args.metrics_out and lead:
                print(f"wrote telemetry stream -> {args.metrics_out}")
    finally:
        if mesh is not None:
            mesh.close()


if __name__ == "__main__":
    main()
