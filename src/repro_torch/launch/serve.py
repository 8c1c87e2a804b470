"""CLI launcher: serve a WASH population through continuous batching.

Port of the ``--continuous`` path of ``repro/launch/serve.py``.  Loads a
population (random-init from ``--seed``, or ``--ckpt``, a stacked
population ``.npz`` written by either package's ``train.checkpoint.save``,
for example the JAX train CLI's ``--ckpt-population``), turns it into the
``--mode``'s serving params, and serves a mixed-length request stream
through ``serving.batching.ContinuousServer`` over a paged KV cache,
reporting tokens/s and the runtime's page accounting.  On the card every
decode attend runs the hand-written paged-attention kernel.

  python -m repro_torch.launch.serve --arch llama3.2-3b --continuous \\
      --population 2 --requests 16 --max-slots 8 --seq-len 512 --max-new 32

  python -m repro_torch.launch.serve --arch llama3.2-3b --reduced \\
      --continuous --device cpu --requests 8 --max-new 8 --seq-len 16
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import population as pop
from repro_torch.core.device import resolve_device
from repro_torch.kernels import paged_attention
from repro_torch.models import transformer as M
from repro_torch.serving import batching
from repro_torch.serving.engine import MODES
from repro_torch.train import checkpoint


def init_population(cfg, n: int, seed: int, device):
    """N independently initialized members, stacked (member i draws from
    seed ``seed * 1000 + i``)."""
    return pop.stack([M.init_params(cfg, seed=seed * 1000 + i, device=device)
                      for i in range(n)])


def _population(args, cfg, device):
    if args.ckpt:
        like = pop.tree_map(
            lambda x: x.unsqueeze(0).expand((args.population,) + x.shape),
            M.param_shapes(cfg))
        popn = checkpoint.restore(args.ckpt, like, device=device)
        print(f"restored population <- {args.ckpt}")
        return popn
    return init_population(cfg, args.population, args.seed, device)


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
        max_pages_per_slot=max_pages, kv_dtype=args.kv_dtype, device=device,
    )
    reqs = mixed_stream(cfg, args.requests, args.seq_len, args.max_new,
                        args.seed, args.temperature)
    launches0 = paged_attention.launches
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = server.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
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
          f"shared {st['pages_shared']}, peak {st['peak_pages_in_use']}")
    if len(out) != len(reqs):
        raise RuntimeError(f"served {len(out)} of {len(reqs)} requests")
    return out


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
    ap.add_argument("--mode", default="soup", choices=list(MODES),
                    help="serving mode: soup (1x cost), member (one member), "
                         "ensemble (Nx decode, averaged logits)")
    ap.add_argument("--member", type=int, default=0,
                    help="which member --mode member serves")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy")
    ap.add_argument("--max-new", type=int, default=32,
                    help="the maximum of the per-request new-token budgets")
    ap.add_argument("--seq-len", type=int, default=32,
                    help="the maximum of the per-request prompt lengths")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for weights, prompts, and stream shape")
    ap.add_argument("--ckpt", default=None,
                    help="restore a stacked-population .npz (for example "
                         "from the JAX train CLI's --ckpt-population)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve the stream through the continuous-batching "
                         "paged-KV runtime (the only runtime ported)")
    ap.add_argument("--requests", type=int, default=16,
                    help="number of requests in the stream")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="in-flight request slots (the decode step's batch)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=256,
                    help="KV page-pool size shared by all slots")
    ap.add_argument("--kv-dtype", default=None, choices=["int8"],
                    help="quantize the paged KV pools to int8, one scale per "
                         "(layer, page) (default: the model's param dtype)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on: cuda (the default; "
                         "raises without a card) or cpu")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.continuous:
        ap.error("only the --continuous runtime is ported; add --continuous")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    popn = _population(args, cfg, device)
    _serve_continuous(popn, cfg, args, device)


if __name__ == "__main__":
    main()
