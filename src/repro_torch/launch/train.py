"""CLI launcher: train a WASH population of a language model.

Port of ``repro/launch/train.py``.  ``--engine vmap`` (the default) runs
the reference loop on one device; ``--engine shard_map`` runs the
ensemble engine (``train/engine.py``) over the ranks that ``torchrun``
starts: ``--mesh ens`` one block of N / world members a rank (at world 1
the whole population on one device); ``--mesh ens_dp`` / ``ens_dp_mp``
an (E, D[, M]) mesh of the ranks (``launch/mesh.py``, the reference's
fill, or ``--mesh-shape E,D,M``), where members split over the model
axis by ``sharding/rules.py``'s specs and batches over a data axis that
carries no members; ``--mesh ens_pp`` / ``ens_dp_pp`` an (E[, D], S)
mesh whose pipe axis cuts each member's stacked blocks into S stages
(``--pp-stages S`` or the shape's last size), trained by the pipelined
engine (``train_population_pipelined``: GPipe over ``--microbatches``
microbatches a step) on ``models/transformer.py::pipeline_stage_fns``;
a config the pipeline cannot stage-split is refused before any weight
is made (``pipeline_supported``).
WASH kinds on that engine take bucketed plans: ``--mode dense`` is
switched to bucketed with a note, as in the reference.  On the card
every WASH shuffle of a stacked block runs the hand-written CUDA kernels
(``kernels/wash_shuffle``), an rwkv6 model's time mixes run the WKV
kernel forward and its backward kernel (``kernels/rwkv6_scan``), and a
hybrid (hymba) model's Mamba paths the selective-scan kernel forward and
its backward (``kernels/selective_scan``); the device decides, there is
no switch (so the reference's ``--pallas-shuffle`` has no counterpart).
A config those kernels cannot take is refused on the card before any
weight moves there (``models/transformer.py::cuda_supported``).
``--ckpt-population`` writes the stacked population in the format
``repro_torch.launch.serve --ckpt`` (and the JAX package's
``train.checkpoint.restore``) reads.

  python -m repro_torch.launch.train --arch llama3.2-3b --population 2 \\
      --mixing wash --mode bucketed --base-p 0.01 --steps 4 \\
      --batch-size 2 --seq-len 256 --ckpt-population build/pop.npz

  python -m repro_torch.launch.train --arch llama3.2-3b --reduced \\
      --device cpu --population 2 --mode bucketed --steps 4 \\
      --batch-size 2 --seq-len 16

  python -m repro_torch.launch.train --arch llama3.2-3b --population 2 \\
      --mode bucketed --steps 4 --batch-size 2 --seq-len 256 \\
      --engine shard_map

  torchrun --nproc-per-node=2 -m repro_torch.launch.train \\
      --arch llama3.2-3b --reduced --device cpu --population 4 \\
      --mode bucketed --steps 4 --batch-size 2 --seq-len 16 \\
      --engine shard_map

  torchrun --nproc-per-node=4 -m repro_torch.launch.train \\
      --arch llama3.2-3b --population 2 --mixing wash_opt \\
      --optimizer adamw --mode bucketed --steps 4 --batch-size 2 \\
      --seq-len 256 --engine shard_map --mesh ens_dp_mp

  torchrun --nproc-per-node=4 -m repro_torch.launch.train \\
      --arch llama3.2-3b --population 2 --mode bucketed --steps 4 \\
      --batch-size 4 --seq-len 256 --engine shard_map --mesh ens_pp \\
      --mesh-shape 1,4 --microbatches 4

  python -m repro_torch.launch.train --arch rwkv6-3b --population 2 \\
      --mode bucketed --steps 4 --batch-size 2 --seq-len 256 \\
      --ckpt-population build/pop.npz

Under ``torchrun`` every rank trains its block; rank 0 alone prints,
gathers the population (``core.population.gather_population``; member
shards over the model axis and stages over the pipe axis first) for the
averaged-model loss and ``--ckpt`` / ``--ckpt-population``, and writes
``--history`` and ``--metrics-out``.

``--metrics-out`` writes the telemetry event stream (``repro_torch.obs``:
the step or chunk spans, the ``train.comm_volume`` events, the final
metric snapshots) as JSONL, which ``tools/check_metrics_schema.py
--require-comm`` checks; ``--profile-dir`` writes a Chrome trace of the
first steps.  Every flag is documented with its default: ``--help``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import shardplan
from repro_torch.core.device import resolve_device
from repro_torch.core.layer_index import infer_layer_ids, total_layers
from repro_torch.core.mixing import MixingConfig
from repro_torch.core.population import gather_population
from repro_torch.core.prng import fold_in
from repro_torch.data import make_lm_task, sample_tokens
from repro_torch.launch.mesh import HOST_MESH_AXES, HostMesh, make_host_mesh
from repro_torch.launch.specs import concrete_batch
from repro_torch.models import transformer as M
from repro_torch.serving.engine import averaged_params
from repro_torch.sharding import rules
from repro_torch.train import checkpoint
from repro_torch.train.engine import StageFns, train_population_pipelined
from repro_torch.train.loop import train_population


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
    ap.add_argument("--engine", default="vmap", choices=["vmap", "shard_map"],
                    help="vmap: the reference loop on one device; "
                         "shard_map: the ensemble engine over the ranks "
                         "torchrun starts (forces bucketed plans for wash "
                         "kinds)")
    ap.add_argument("--steps", type=int, default=200,
                    help="total optimizer steps per member")
    ap.add_argument("--record-every", type=int, default=None,
                    help="history record period (default: steps // 10); "
                         "also the ensemble engine's chunk window length")
    ap.add_argument("--sync-staging", action="store_true",
                    help="shard_map engine: stage each chunk's batches "
                         "synchronously; by default a staging thread makes "
                         "the next chunk's while one runs (off on the CPU "
                         "when chunks are too short to pay for the handoff)")
    ap.add_argument("--no-gate-split", action="store_true",
                    help="shard_map engine: one chunk per record window, "
                         "instead of running no-mix gate runs on the "
                         "collective-free chunk function")
    ap.add_argument("--mesh", default="ens", choices=sorted(HOST_MESH_AXES),
                    help="shard_map engine: mesh layout over the ranks; ens "
                         "(one block of members a rank), ens_dp (E, D), "
                         "ens_dp_mp (E, D, M: members split over the model "
                         "axis), ens_pp (E, S) and ens_dp_pp (E, D, S): "
                         "members' blocks cut into S pipeline stages")
    ap.add_argument("--mesh-shape", default=None,
                    help="explicit comma-separated axis sizes for --mesh "
                         "(their product must be the world); default: E "
                         "the largest divisor of N that fits, then the "
                         "model axis, then the data axis")
    ap.add_argument("--pp-stages", type=int, default=None,
                    help="--mesh ens_pp/ens_dp_pp: pipeline stages S (the "
                         "pipe axis's size; default 1), which must divide "
                         "the ranks left after the ens axis and the layers")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="--mesh ens_pp/ens_dp_pp: GPipe microbatches M a "
                         "step, which must divide each member's batch on "
                         "a rank")
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
    ap.add_argument("--metrics-out", default=None,
                    help="write the telemetry event stream (spans, "
                         "comm-volume checkpoints, final metric snapshots) "
                         "as JSONL here; check it with "
                         "tools/check_metrics_schema.py --require-comm")
    ap.add_argument("--metrics-summary", action="store_true",
                    help="print a telemetry metric summary on exit")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of the first "
                         "instrumented spans into this directory")
    return ap


def member_specs(cfg, mcfg: MixingConfig, mesh: HostMesh, population: int):
    """The member specs of ``cfg`` on ``mesh``: ``rules.param_pspecs``
    over a ``meta`` template when the model axis splits members (None
    otherwise), checked by the shard-local planner on that template, so
    a spec the mesh cannot take is refused before any weight is made."""
    if mesh.shape.get("model", 1) == 1:
        return None
    shapes = M.param_shapes(cfg)
    specs = rules.param_pspecs(shapes, cfg, mesh)
    shardplan.plan_population_mixing(
        mesh, shapes, specs, mcfg, infer_layer_ids(shapes, cfg.num_layers),
        total_layers(cfg.num_layers), population)
    return specs


def main(argv=None, cfg=None):
    """Run the CLI on ``argv``; returns the loop's result.  ``cfg``, when
    given, is trained in place of ``--arch``'s config: a caller's cut of
    it (fewer layers, say), which no flag expresses."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.record_every is not None and args.record_every < 1:
        ap.error("--record-every must be >= 1")
    sharded = args.engine == "shard_map"
    if not sharded and (args.sync_staging or args.no_gate_split
                        or args.mesh != "ens" or args.mesh_shape is not None):
        ap.error("--sync-staging/--no-gate-split/--mesh/--mesh-shape "
                 "require --engine shard_map")
    pipelined = args.mesh in ("ens_pp", "ens_dp_pp")
    if (args.pp_stages is not None or args.microbatches > 1) and not pipelined:
        ap.error("--pp-stages/--microbatches require --mesh ens_pp or "
                 "ens_dp_pp")
    mesh_shape = None
    if args.mesh_shape is not None:
        try:
            mesh_shape = tuple(int(x) for x in args.mesh_shape.split(","))
        except ValueError:
            ap.error(f"--mesh-shape {args.mesh_shape!r} is not a "
                     "comma-separated list of integers")
    if cfg is None:
        cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    reason = M.train_supported(cfg)
    if reason is not None:
        raise NotImplementedError(f"training {cfg.name}: {reason}")
    stage_fns = M.pipeline_stage_fns(cfg) if pipelined else None
    mesh = (make_host_mesh(args.population, args.mesh,
                           mesh_shape=mesh_shape,
                           pp_stages=args.pp_stages, device=args.device)
            if sharded else None)
    device = mesh.device if sharded else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    if device.type == "cuda":  # before any weight reaches the card
        reason = M.cuda_supported(cfg, "train", args.seq_len)
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
    if (sharded and args.mixing in ("wash", "wash_opt")
            and args.mode != "bucketed"):
        if lead:
            print("note: engine=shard_map runs bucketed plans only; "
                  "switching --mode dense -> bucketed")
        mcfg = dataclasses.replace(mcfg, mode="bucketed")
    engine_opts = None
    if sharded:
        engine_opts = {"async_staging": False if args.sync_staging else None,
                       "split_gate_runs": not args.no_gate_split}
        if isinstance(mesh, HostMesh):
            engine_opts["param_specs"] = member_specs(cfg, mcfg, mesh,
                                                      args.population)
            if lead:
                r = mesh.roles
                split = tuple(a for a in r.model_axes if mesh.shape[a] > 1)
                stages = (f", blocks in {mesh.num_stages} stages, "
                          f"{args.microbatches} microbatch(es) a step"
                          if pipelined else "")
                print(f"mesh: {mesh.shape} (population over {r.pop_axes}, "
                      f"batches split over {r.dp_axes or 'none'}, members "
                      f"split over {split or 'none'}{stages}; "
                      f"{mesh.n_local} members a rank, {device})")
        elif lead:
            print(f"mesh: ens={mesh.world} ({mesh.n_local} members a rank, "
                  f"{device})")
    record_every = (args.record_every if args.record_every is not None
                    else max(args.steps // 10, 1))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tel = obs.configure(jsonl=args.metrics_out if lead else None,
                        console=args.metrics_summary and lead,
                        profile_dir=args.profile_dir if lead else None)
    try:
        if pipelined:
            res = train_population_pipelined(
                args.seed,
                lambda s: M.init_params(cfg, seed=s, device=device),
                StageFns(*stage_fns), data_fn, tcfg, mcfg, cfg.num_layers,
                record_every=record_every, mesh=mesh,
                microbatches=args.microbatches,
                member_tpl=M.param_shapes(cfg), device=device, **engine_opts)
        else:
            res = train_population(
                args.seed,
                lambda s: M.init_params(cfg, seed=s, device=device),
                loss_fn, data_fn, tcfg, mcfg, cfg.num_layers,
                record_every=record_every, engine=args.engine,
                device=device, mesh=mesh, engine_opts=engine_opts,
            )
    finally:
        tel.finalize()
    population = (gather_population(res.population, mesh,
                                    shard_dims=res.shard_dims,
                                    stage_split=res.stage_split)
                  if sharded else res.population)
    if sharded:
        mesh.close()
    if not lead:
        return res
    if args.metrics_out:
        print(f"wrote telemetry stream -> {args.metrics_out}")

    soup = averaged_params(population)
    print(f"arch={cfg.name} mixing={args.mixing} steps={args.steps} "
          f"engine={args.engine}")
    print(f"final mean member loss : {res.history['loss'][-1]:.4f}")
    print(f"consensus distance     : {res.history['consensus'][-1]:.4f}")
    print(f"scalars sent per member: {res.comm_scalars:.3e}")
    tokens = args.steps * args.population * args.batch_size * args.seq_len
    wall = res.history["wall_s"][0]
    phases = ", ".join(f"{p} {sum(v) / args.steps:.1f} ms"
                       for p, v in res.phase_ms.items())
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
        written = checkpoint.save(args.ckpt_population, population)
        print(f"saved population -> {written}")
    if args.history:
        os.makedirs(os.path.dirname(args.history) or ".", exist_ok=True)
        with open(args.history, "w") as f:
            json.dump(res.history, f, indent=2)
    return res


if __name__ == "__main__":
    main()
