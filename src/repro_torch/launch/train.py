"""CLI launcher: train a WASH population of a language model.

Port of ``repro/launch/train.py`` with the reference loop
(``--engine vmap``).  On the card every WASH shuffle of the stacked
population runs the hand-written CUDA kernels (``kernels/wash_shuffle``),
and an rwkv6 model's time mixes run the WKV kernel forward and its
backward kernel (``kernels/rwkv6_scan``); the device decides, there is no
switch.  A config those kernels cannot take is refused on the card before
any weight moves there (``models/transformer.py::cuda_supported``).
``--ckpt-population`` writes the stacked population in the format
``repro_torch.launch.serve --ckpt`` (and the JAX package's
``train.checkpoint.restore``) reads.

  python -m repro_torch.launch.train --arch llama3.2-3b --population 2 \\
      --mixing wash --mode bucketed --base-p 0.01 --steps 4 \\
      --batch-size 2 --seq-len 256 --ckpt-population build/pop.npz

  python -m repro_torch.launch.train --arch llama3.2-3b --reduced \\
      --device cpu --population 2 --mode bucketed --steps 4 \\
      --batch-size 2 --seq-len 16

  python -m repro_torch.launch.train --arch rwkv6-3b --population 2 \\
      --mode bucketed --steps 4 --batch-size 2 --seq-len 256 \\
      --ckpt-population build/pop.npz

Every flag is documented with its default: ``--help``.  The multi-device
engine and its flags (``--engine shard_map``, ``--mesh*``,
``--pp-stages``, ``--microbatches``, ``--sync-staging``,
``--no-gate-split``) and telemetry (``--metrics-*``, ``--profile-dir``)
are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.mixing import MixingConfig
from repro_torch.core.prng import fold_in
from repro_torch.data import make_lm_task, sample_tokens
from repro_torch.launch.specs import concrete_batch
from repro_torch.models import transformer as M
from repro_torch.serving.engine import averaged_params
from repro_torch.train import checkpoint
from repro_torch.train.loop import PHASES, train_population


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    ap.add_argument("--arch", required=True,
                    help="architecture name from repro_torch.configs (e.g. "
                         "llama3.2-3b)")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (small, float32) config variant")
    ap.add_argument("--population", type=int, default=4,
                    help="population size N")
    ap.add_argument("--mixing", default="wash",
                    choices=["none", "wash", "wash_opt", "papa", "papa_all"],
                    help="mixing method: wash (paper Eq. 3), wash_opt "
                         "(shuffle optimizer moments too), papa/papa_all "
                         "(parameter-averaging baselines), none")
    ap.add_argument("--base-p", type=float, default=0.01,
                    help="WASH base shuffle probability p (paper Eq. 6)")
    ap.add_argument("--schedule", default="decreasing",
                    choices=["decreasing", "constant", "increasing"],
                    help="layer-wise shuffle-probability schedule")
    ap.add_argument("--mode", default="dense", choices=["dense", "bucketed"],
                    help="shuffle plan mode: dense per-coordinate permutes "
                         "or bucketed cyclic shifts (sparse, in place)")
    ap.add_argument("--steps", type=int, default=200,
                    help="total optimizer steps per member")
    ap.add_argument("--record-every", type=int, default=None,
                    help="history record period (default: steps // 10)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="per-member batch size (synthetic LM task)")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="training sequence length")
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"],
                    help="member optimizer")
    ap.add_argument("--lr", type=float, default=0.05,
                    help="peak learning rate")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for init, data, and shuffle plans")
    ap.add_argument("--ckpt", default=None,
                    help="save the averaged model (soup) here (.npz)")
    ap.add_argument("--ckpt-population", default=None,
                    help="save the full stacked population here (.npz): "
                         "the input of repro_torch.launch.serve --ckpt")
    ap.add_argument("--history", default=None,
                    help="dump the training history (loss/consensus/comm "
                         "per record window) as JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on: cuda (the default; "
                         "raises without a card) or cpu")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.record_every is not None and args.record_every < 1:
        ap.error("--record-every must be >= 1")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    reason = M.train_supported(cfg)
    if reason is not None:
        raise NotImplementedError(f"training {cfg.name}: {reason}")
    if device.type == "cuda":  # before any weight reaches the card
        reason = M.cuda_supported(cfg, "train")
        if reason is not None:
            raise NotImplementedError(f"training {cfg.name} on the card: "
                                      f"{reason}")

    task = make_lm_task(fold_in(args.seed, 1), vocab=min(cfg.vocab_size, 512),
                        device=device)

    def data_fn(m, step, seed):
        b = concrete_batch(cfg, fold_in(seed, 10), args.batch_size,
                           args.seq_len, device=device)
        b["tokens"] = sample_tokens(task, seed, args.batch_size,
                                    args.seq_len) % cfg.vocab_size
        return b

    def loss_fn(params, batch):
        loss, _ = M.loss_fn(params, cfg, batch)
        return loss

    tcfg = TrainConfig(
        population=args.population, optimizer=args.optimizer, lr=args.lr,
        total_steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, seed=args.seed,
    )
    mcfg = MixingConfig(kind=args.mixing, base_p=args.base_p,
                        schedule=args.schedule, mode=args.mode)
    record_every = (args.record_every if args.record_every is not None
                    else max(args.steps // 10, 1))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res = train_population(
        args.seed, lambda s: M.init_params(cfg, seed=s, device=device),
        loss_fn, data_fn, tcfg, mcfg, cfg.num_layers,
        record_every=record_every, device=device,
    )

    soup = averaged_params(res)
    print(f"arch={cfg.name} mixing={args.mixing} steps={args.steps} "
          f"engine=vmap")
    print(f"final mean member loss : {res.history['loss'][-1]:.4f}")
    print(f"consensus distance     : {res.history['consensus'][-1]:.4f}")
    print(f"scalars sent per member: {res.comm_scalars:.3e}")
    tokens = args.steps * args.population * args.batch_size * args.seq_len
    wall = res.history["wall_s"][0]
    phases = ", ".join(f"{p} {sum(res.phase_ms[p]) / args.steps:.1f} ms"
                       for p in PHASES)
    print(f"trained tokens/s       : {tokens / wall:.1f} ({wall:.2f} s; "
          f"per step {phases}; device={device})")
    if device.type == "cuda":
        print(f"peak device memory     : "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")

    eval_batch = data_fn(0, 0, fold_in(args.seed, 777))
    with torch.no_grad():
        loss_soup, _ = M.loss_fn(soup, cfg, eval_batch)
    print(f"averaged-model loss    : {float(loss_soup):.4f}")

    if args.ckpt:
        written = checkpoint.save(args.ckpt, soup)
        print(f"saved averaged model -> {written}")
    if args.ckpt_population:
        written = checkpoint.save(args.ckpt_population, res.population)
        print(f"saved population -> {written}")
    if args.history:
        os.makedirs(os.path.dirname(args.history) or ".", exist_ok=True)
        with open(args.history, "w") as f:
            json.dump(res.history, f, indent=2)
    return res


if __name__ == "__main__":
    main()
