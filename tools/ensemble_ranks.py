#!/usr/bin/env python3
"""The ensemble engine across ranks, one device a rank, against world 1.

Run under ``torchrun``, a process a card (``nccl``) or, with ``--device
cpu``, a process a CPU rank (``gloo``), from the root of a checkout:

    torchrun --standalone --nproc-per-node=4 tools/ensemble_ranks.py
    torchrun --standalone --nproc-per-node=4 tools/ensemble_ranks.py \\
        --device cpu --small

Four ranks are needed.  Six parts, each failing the run on a mismatch
(``--parts`` runs some of them, e.g. ``--parts 5``):

  1. ring: the blocked bucketed apply (``core/shuffle.py``) on
     llama3.2-3b's stacked ``blocks.mlp.w1`` (N = 4, bf16, the layered
     bucketed plan at p = 0.01) across the 4 ranks (a member a rank) and
     across ranks [0, 1] and [2, 3] (two members a rank), against world 1
     (the stacked leaf through ``ops.bucketed_shuffle_``, the shuffle
     kernel on the card): bitwise, and each timed (CUDA events on the
     card, the host clock on the CPU; the slowest rank's median of 5),
     beside the bytes each rank sends;
  2. engine: llama3.2-3b at full width cut to 4 layers, float32, N = 4,
     SGD, 3 steps, bucketed WASH (p = 0.01), PAPA (``papa_every=2``) and
     ``none``, at worlds 4 and 2 against world 1 on rank 0: the
     populations gathered on rank 0 bitwise equal, the comm equal;
  3. full width: llama3.2-3b (28 layers, bf16, N = 4, a member a rank,
     SGD, bucketed WASH at p = 0.01, 2 x 256 tokens a member, 4 steps)
     through the train CLI's ``main`` with ``--engine shard_map``, twice:
     the comm a step against ``static_mix_comm``, each rank's step split
     (ms a step: forward+backward, optimizer, mixing) and peak memory;
  4. meshes: (a) part 2's 4-layer float32 cut on the ens x data x model
     meshes (2,1,2), (1,1,4) and (2,2,1) (``launch/mesh.py::
     make_host_mesh``, members split over the model axis by
     ``sharding/rules.py``), N = 2 and 4, against world 1 on rank 0: PAPA
     (``papa_every=2``, 3 steps) bitwise where no data axis splits
     batches, WASH (1 step) bitwise on the leaves no axis splits and the
     same multiset per coordinate on the others, (2,2,1) at N = 2
     (batches split over the data axis) within rtol 2e-5, atol 1e-6;
     (b) full-width llama3.2-3b, N = 2, bf16, AdamW, WASH+Opt (bucketed
     p = 0.01), 2 x 256 tokens a member, 4 steps, on (2,1,2) through the
     train CLI: the comm a step (27,050,448.0), each rank's step split
     with the first mixing step apart, peak memory and trained tokens/s;
     (c) the same population on one card (rank 0 alone, the vmap loop),
     run before every other part, while no NCCL communicator holds
     memory on the card: where it runs out of memory;
  5. the pipeline: (a) part 2's 4-layer float32 cut through the
     pipelined engine (``train_population_pipelined``, each member's
     blocks cut into stages over the pipe axis) on ``ens_pp`` (1,4) with
     M = 4 microbatches, (2,2) with M = 1 and 4, and ``ens_dp_pp``
     (1,2,2) at N = 4 with M = 2, against world 1 on rank 0: ``none``
     and PAPA (``papa_every=2``, 3 steps) within rtol 2e-5, atol 2e-6;
     WASH (1 step) on (1,4) and (2,2) the same multiset per coordinate
     as the unmixed step, the leaves replicated over the stages bitwise
     equal on every stage; (b) full-width llama3.2-3b on ``--mesh ens_pp
     --mesh-shape 1,4`` through the train CLI: N = 2, bf16, SGD,
     bucketed WASH at p = 0.01, 4 x 256 tokens a member, M = 4, 4 steps,
     every bucketed launch held bitwise against its plain version: the
     comm a step (9,016,861.0) and each stage's share, each rank's step
     split (forward ticks, backward ticks, the pipe sum of the
     replicated gradients, optimizer, mixing; the first step apart), the
     measured bubble beside the schedule's (S - 1) / (M + S - 1), peak
     memory on each card (training, and with the population gathered),
     trained tokens/s; (c) the same on (2,2), where the ring runs inside
     each stage (9,016,865.0);
  6. serving: (a) part 2's 4-layer float32 cut, the soup of a random N =
     2 population (B = 4 prompts of 64 tokens, 8 new), served stage-split
     over 4 stages and over 2 (ranks [0, 1] and [2, 3]), greedy and at
     temperature 0.8, and on the data mesh of 4 (B = 8 split, soup and
     ensemble; B = 6 replicated), each rank's tokens bitwise equal to its
     world-1 run; then the serve CLI with ``--pp-stages 4`` and with
     ``--mesh data`` against the CLI without a mesh; (b) full-width
     llama3.2-3b (bf16, the soup of a random N = 2 population, B = 4 x
     2048 prompt tokens, 32 new): at world 1 on every card, then staged
     over 4 stages (7 layers a card) and over 2 (14): tokens bitwise equal
     to world 1's, and on each card the peak memory (drawing, and the
     timed request), the bytes of its weights, the prefill s and the
     decode-step ms, and at world 1 and S=4 one more request under
     ``torch.profiler``: the ops where the host spends its time; then
     the data mesh of 4 at B = 16 (4 rows a rank),
     ensemble and soup: each rank's rows bitwise equal to world 1 serving
     them alone, the agreement with a one-card B = 16 run, tokens/s
     against that one card.  Every timed number is a request's second
     run (the first builds the programs and sets NCCL's communicators up).

``--small`` runs every part on the reduced config instead (a CPU run;
parts 5 and 6 on the reduced config at 4 layers).
Rank 0 prints the card's name and power limit, then the results as one
JSON line, last.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import averaging  # noqa: E402
from repro_torch.core import layer_index as tli  # noqa: E402
from repro_torch.core import population as pop  # noqa: E402
from repro_torch.core import shardplan  # noqa: E402
from repro_torch.core import shuffle as shf  # noqa: E402
from repro_torch.core.mixing import MixingConfig, static_mix_comm  # noqa: E402
from repro_torch.core.prng import fold_in  # noqa: E402
from repro_torch.core.schedules import layer_probability_array  # noqa: E402
from repro_torch.data import make_lm_task, sample_tokens  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import wash_shuffle as ws  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    EnsMesh, make_host_data_mesh, make_host_ensemble_mesh, make_host_mesh,
    make_host_pipe_mesh)
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models import transformer as M  # noqa: E402
from repro_torch.serving import engine as serving  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train import engine  # noqa: E402

WORLD, N, P = 4, 4, 0.01


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (nccl, a card a rank) or cpu (gloo)")
    ap.add_argument("--small", action="store_true",
                    help="the reduced llama3.2-3b config in every part")
    ap.add_argument("--parts", default="1,2,3,4,5,6",
                    help="comma-separated parts to run (1-6)")
    return ap


def fail(msg: str) -> None:
    raise SystemExit(f"ensemble_ranks: FAILED: {msg}")


def say(rank: int, msg: str) -> None:
    if rank == 0:
        print(msg, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_ms(fn, dev, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls."""
    out = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def subgroups():
    """Every rank makes every group, in one order: the world's ranks,
    then [0, 1] and [2, 3]."""
    return dist.new_group(list(range(WORLD))), [dist.new_group([0, 1]),
                                                dist.new_group([2, 3])]


def ring(rank: int, dev, cfg, groups) -> dict:
    """Part 1: the stacked leaf blocks.mlp.w1 of N members, the blocked
    apply on 4 and on 2 ranks against world 1."""
    all4, pairs = groups
    shape = tuple(M.param_shapes(cfg)["blocks"]["mlp"]["w1"].shape)
    L, d_rest = shape[0], int(np.prod(shape[1:]))
    p_vec = np.clip(layer_probability_array(
        P, np.arange(1, L + 1), tli.total_layers(L), "decreasing"), 0, 1)
    idx = shf.bucketed_plan_layered(7, L, d_rest, N, p_vec, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((N, L * d_rest), generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    want = x.clone()
    ops.bucketed_shuffle_(want, idx)  # world 1: the kernel on the card
    sums = [torch.zeros(2, dtype=torch.float64, device=dev)
            for _ in range(WORLD)]
    check = torch.stack([idx.double().sum(), x[:, ::997].double().sum()])
    dist.all_gather(sums, check)
    if any(not torch.equal(s, sums[0]) for s in sums):
        fail(f"ranks drew different plans or leaves: {sums}")
    spare = x.clone()
    out = {"leaf": "blocks.mlp.w1", "shape": [N, L * d_rest],
           "k_per": int(idx.shape[1]),  # the kernel in place, again and again
           "world_1_ms": timed_ms(lambda: ops.bucketed_shuffle_(spare, idx),
                                  dev)}
    del spare
    for name, world, group in (("4 ranks", 4, all4),
                               ("2 ranks", 2, pairs[rank // 2])):
        mesh = make_host_ensemble_mesh(N, dev.type, group=group)
        a = mesh.member_offset
        block = x[a:a + mesh.n_local].clone()
        shf.bucketed_apply_collective_blocked(block, idx, mesh)
        full = pop.gather_population({"w": block}, mesh)
        same = True if full is None else bool(torch.equal(full["w"], want))
        flags = [None] * WORLD
        dist.all_gather_object(flags, same)
        if not all(flags):
            fail(f"ring on {name}: the gathered leaf differs from world 1")
        ms = timed_ms(lambda: shf.bucketed_apply_collective_blocked(
            block, idx, mesh), dev)  # in place, again and again
        each = [None] * WORLD
        dist.all_gather_object(each, ms)
        # exchanges a step: bucket s crosses ranks for each of its q, q+1
        # blocks that lie on another rank
        sent = 0
        for s in range(1, N):
            q, r = divmod(s, mesh.n_local)
            for qq in ((q,) if r == 0 else (q, q + 1)):
                if qq % world:
                    sent += mesh.n_local * idx.shape[1] * x.element_size()
        out[name] = {"bitwise": True, "ms_slowest_rank": max(each),
                     "ms_each_rank": each, "bytes_sent_a_rank": sent}
        del block, full
    del x, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def engine_worlds(rank: int, dev, cfg, groups) -> dict:
    """Part 2: the engine at worlds 4, 2 and 1 on the same population."""
    all4, pairs = groups
    task = make_lm_task(fold_in(0, 1), vocab=min(cfg.vocab_size, 512),
                        device=dev)

    def data_fn(m, step, s):
        return {"tokens": sample_tokens(task, s, 2, 64)}

    def train(mcfg, mesh):
        tcfg = TrainConfig(population=N, optimizer="sgd", lr=0.05,
                           total_steps=3, seed=0)
        return engine.train_population_sharded(
            0, lambda s: M.init_params(cfg, seed=s, device=dev),
            lambda p, b: M.loss_fn(p, cfg, b)[0], data_fn, tcfg, mcfg,
            cfg.num_layers, record_every=3, mesh=mesh, device=dev.type)

    out = {}
    for kind, mcfg in (("wash", MixingConfig(kind="wash", base_p=P,
                                             mode="bucketed")),
                       ("papa", MixingConfig(kind="papa", papa_every=2)),
                       ("none", MixingConfig(kind="none"))):
        ref = None
        if rank == 0:  # world 1: the population whole on rank 0
            t0 = time.perf_counter()
            res = train(mcfg, EnsMesh(0, 1, N, 0, dev))
            ref = (res.population, res.comm_scalars, time.perf_counter() - t0)
            del res
        dist.barrier()
        row = {}
        for name, world, group in (("4 ranks", 4, all4),
                                   ("2 ranks", 2, pairs[0])):
            same = True
            if rank < world:
                mesh = make_host_ensemble_mesh(N, dev.type, group=group)
                t0 = time.perf_counter()
                res = train(mcfg, mesh)
                wall = time.perf_counter() - t0
                full = pop.gather_population(res.population, mesh)
                if rank == 0:
                    same = all(torch.equal(a, b) for a, b in zip(
                        pop.tree_leaves(full), pop.tree_leaves(ref[0])))
                    same = same and res.comm_scalars == ref[1]
                    row[name] = {"bitwise": same, "s": wall,
                                 "comm": res.comm_scalars}
                del res, full
            flags = [None] * WORLD
            dist.all_gather_object(flags, same)
            if not all(flags):
                fail(f"engine, {kind}, {name}: the population differs from "
                     "world 1")
        if rank == 0:
            row["1 rank"] = {"s": ref[2], "comm": ref[1]}
            out[kind] = row
        del ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def full_width(rank: int, dev, cfg_name: str, small: bool) -> dict:
    """Part 3: the train CLI at world 4, a member a rank, twice: the first
    run's first ring exchanges also set up the communicator's peer
    connections, the second's find them made."""
    argv = ["--arch", cfg_name, "--population", str(N), "--mixing", "wash",
            "--mode", "bucketed", "--base-p", str(P), "--optimizer", "sgd",
            "--steps", "4", "--batch-size", "2", "--seq-len",
            "16" if small else "256", "--record-every", "1", "--lr", "0.01",
            "--device", dev.type, "--engine", "shard_map"]
    if small:
        argv.append("--reduced")
    cfg = get_arch(cfg_name).reduced() if small else get_arch(cfg_name)
    shapes = M.param_shapes(cfg)
    static = static_mix_comm(
        shapes, MixingConfig(kind="wash", base_p=P, mode="bucketed"),
        tli.infer_layer_ids(shapes, cfg.num_layers),
        tli.total_layers(cfg.num_layers), N)
    out = {"comm_a_step": static}
    for run in ("first", "second"):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        res = train_cli.main(argv)
        sync(dev)
        steps = np.diff([0.0] + res.history["comm"]).tolist()
        if steps != [static] * 4:
            fail(f"full width: comm a step {steps}, static_mix_comm {static}")
        mine = {p: [round(v, 3) for v in res.phase_ms[p]]
                for p in res.phase_ms}
        mine["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                            if dev.type == "cuda" else None)
        each = [None] * WORLD
        dist.all_gather_object(each, mine)
        out[run] = {"losses": res.history["loss"],
                    "wall_s": res.history["wall_s"][0], "ranks": each}
        del res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


MESHES = ((2, 1, 2), (1, 1, 4), (2, 2, 1))
COLUMNS = 1 << 24  # columns of a stacked leaf compared at a time


def held(got: torch.Tensor, want: torch.Tensor, how: str,
         atol: float = 1e-6) -> bool:
    """``got`` against ``want`` (stacked leaves), column block by column
    block so that a full-width leaf is never sorted or subtracted whole:
    ``equal`` bitwise, ``permuted`` the same values in each column (a
    shuffle across members), ``close`` within rtol 2e-5 and ``atol``."""
    a, b = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    for c in range(0, a.shape[1], COLUMNS):
        x, y = a[:, c:c + COLUMNS], b[:, c:c + COLUMNS]
        if how == "equal":
            ok = torch.equal(x, y)
        elif how == "permuted":
            ok = torch.equal(torch.sort(x, 0)[0], torch.sort(y, 0)[0])
        else:
            ok = bool(((x - y).abs() <= atol + 2e-5 * y.abs()).all())
        if not ok:
            return False
    return True


def judge(full, ref, split_dims, kind: str, batches: bool, built: int
          ) -> str:
    """Part 4 (a)'s verdict on rank 0: "ok" or what failed."""
    moved = False
    for dims, a, b in zip(split_dims, pop.tree_leaves(full),
                          pop.tree_leaves(ref)):
        if batches:
            if not held(a, b, "close"):
                return "past rtol 2e-5, atol 1e-6"
        elif kind == "wash" and dims:
            if not held(a, b, "permuted"):
                return "a split leaf is no permutation"
            moved = moved or not held(a, b, "equal")
        elif not held(a, b, "equal"):
            return "differs from world 1"
    if kind == "wash" and any(split_dims) and not batches and not moved:
        return "the shard plans moved nothing new"
    if built > 2:
        return f"{built} chunk functions"
    return "ok"


def mesh_engine(rank: int, dev, cfg) -> dict:
    """Part 4 (a): the engine on the multi-axis meshes against world 1."""
    task = make_lm_task(fold_in(0, 1), vocab=min(cfg.vocab_size, 512),
                        device=dev)
    shapes = M.param_shapes(cfg)

    def data_fn(m, step, s):
        return {"tokens": sample_tokens(task, s, 2, 64)}

    def train(mcfg, n, steps, mesh, specs=None):
        tcfg = TrainConfig(population=n, optimizer="sgd", lr=0.05,
                           total_steps=steps, seed=0)
        engine.reset_chunk_trace_count()
        res = engine.train_population_sharded(
            0, lambda s: M.init_params(cfg, seed=s, device=dev),
            lambda p, b: M.loss_fn(p, cfg, b)[0], data_fn, tcfg, mcfg,
            cfg.num_layers, record_every=steps, mesh=mesh,
            param_specs=specs, device=dev.type)
        return res, engine.chunk_trace_count()

    out, meshes = {}, {}
    for n in (2, 4):
        for kind, mcfg, steps in (
                ("papa", MixingConfig(kind="papa", papa_every=2), 3),
                ("wash", MixingConfig(kind="wash", base_p=P,
                                      mode="bucketed"), 1)):
            ref, flags = None, [None] * WORLD
            try:
                if rank == 0:  # world 1: the population whole on rank 0
                    res, _ = train(mcfg, n, steps, EnsMesh(0, 1, n, 0, dev))
                    ref = (res.population, res.comm_scalars)
                    del res
                verdict = "ok"
            except Exception as e:  # noqa: BLE001 (reported, then failed)
                verdict = f"{type(e).__name__}: {e}"[:500]
            dist.all_gather_object(flags, verdict)
            if flags[0] != "ok":
                fail(f"meshes, {kind}, N={n}, world 1: {flags[0]}")
            for shape in MESHES:
                if (shape, n) not in meshes:  # every rank, in one order
                    meshes[shape, n] = make_host_mesh(
                        n, "ens_dp_mp", mesh_shape=shape, device=dev.type)
                mesh = meshes[shape, n]
                specs = (rules.param_pspecs(shapes, cfg, mesh)
                         if shape[2] > 1 else None)
                t0 = time.perf_counter()
                res, built = train(mcfg, n, steps, mesh, specs)
                wall = time.perf_counter() - t0
                full = pop.gather_population(res.population, mesh,
                                             shard_dims=res.shard_dims)
                split_dims = res.shard_dims or [()] * len(
                    pop.tree_leaves(res.population))
                batches = bool(mesh.roles.dp_axes)
                verdict = "ok"
                try:  # a failure on rank 0 reaches every rank below
                    if rank == 0:
                        verdict = judge(full, ref[0], split_dims, kind,
                                        batches, built)
                except Exception as e:  # noqa: BLE001 (reported, then failed)
                    verdict = f"{type(e).__name__}: {e}"[:500]
                if rank == 0:
                    key = f"{kind} N={n} {shape}"
                    out[key] = {
                        "check": ("within rtol 2e-5, atol 1e-6" if batches
                                  else "bitwise" if kind == "papa"
                                  or not res.shard_dims
                                  else "split leaves permuted, others "
                                  "bitwise"),
                        "verdict": verdict, "s": wall,
                        "comm": res.comm_scalars, "world_1_comm": ref[1],
                        "roles": [mesh.roles.pop_axes, mesh.roles.dp_axes],
                        "split_leaves": sum(bool(d) for d in split_dims),
                        "chunk_functions": built}
                flags = [None] * WORLD
                dist.all_gather_object(flags, verdict)
                if flags[0] != "ok":
                    fail(f"meshes, {kind}, N={n}, {shape}: {flags[0]}")
                del res, full
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            del ref
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def mesh_full_width(rank: int, dev, cfg_name: str, small: bool) -> dict:
    """Part 4 (b): full-width WASH+Opt under AdamW, N = 2, each member
    over two cards (the (2, 1, 2) mesh), through the train CLI."""
    argv = ["--arch", cfg_name, "--population", "2", "--mixing", "wash_opt",
            "--mode", "bucketed", "--base-p", str(P), "--optimizer", "adamw",
            "--steps", "4", "--batch-size", "2", "--seq-len",
            "16" if small else "256", "--record-every", "1", "--lr", "1e-4",
            "--device", dev.type, "--engine", "shard_map", "--mesh",
            "ens_dp_mp", "--mesh-shape", "2,1,2"]
    if small:
        argv.append("--reduced")
    cfg = get_arch(cfg_name).reduced() if small else get_arch(cfg_name)
    shapes = M.param_shapes(cfg)
    layout = types.SimpleNamespace(axis_names=("ens", "data", "model"),
                                   shape={"ens": 2, "data": 1, "model": 2})
    pplan = shardplan.plan_population_mixing(
        layout, shapes, rules.param_pspecs(shapes, cfg, layout),
        MixingConfig(kind="wash_opt", base_p=P, mode="bucketed"),
        tli.infer_layer_ids(shapes, cfg.num_layers),
        tli.total_layers(cfg.num_layers), 2)
    static = shardplan.static_shard_mix_comm(
        pplan, {"mu": None, "nu": None, "step": None})
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = train_cli.main(argv)
    sync(dev)
    steps = np.diff([0.0] + res.history["comm"]).tolist()
    if steps != [static] * 4:
        fail(f"mesh full width: comm a step {steps}, the planner's {static}")
    mine = {p: [round(v, 3) for v in res.phase_ms[p]] for p in res.phase_ms}
    mine["first_mix_ms"] = mine["mix"][0]
    mine["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                        if dev.type == "cuda" else None)
    mine["wall_s"] = res.history["wall_s"][0]
    each = [None] * WORLD
    dist.all_gather_object(each, mine)
    tokens = 4 * 2 * 2 * (16 if small else 256)
    out = {"mesh": [2, 1, 2], "comm_a_step": static,
           "split_leaves": sum(bool(i.sharded_dims) for i in pplan.infos),
           "losses": res.history["loss"], "tokens": tokens,
           "tok_s": tokens / max(e["wall_s"] for e in each), "ranks": each}
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def one_card(rank: int, dev, cfg_name: str, small: bool) -> dict:
    """Part 4 (c): the same population, N = 2 with AdamW, on one card
    (rank 0 alone, the vmap loop): where it stops."""
    out = {}
    if rank == 0:
        argv = ["--arch", cfg_name, "--population", "2", "--mixing",
                "wash_opt", "--mode", "bucketed", "--base-p", str(P),
                "--optimizer", "adamw", "--steps", "1", "--batch-size", "2",
                "--seq-len", "16" if small else "256", "--lr", "1e-4",
                "--device", str(dev)]
        if small:
            argv.append("--reduced")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            res = train_cli.main(argv)
            out = {"ran": True, "losses": res.history["loss"]}
            del res
        except Exception as e:  # noqa: BLE001 (the other ranks wait)
            tb = e.__traceback__
            frames = []
            while tb is not None:
                frames.append(tb.tb_frame.f_code.co_name)
                tb = tb.tb_next
            out = {"ran": False, "error": type(e).__name__,
                   "message": str(e).splitlines()[0], "frames": frames[-6:]}
            del e, tb
        out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                           if dev.type == "cuda" else None)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    return out


# part 5 (a): (mesh kind, shape, N, microbatches)
PIPE_MESHES = (("ens_pp", (1, 4), 2, 4), ("ens_pp", (2, 2), 2, 1),
               ("ens_pp", (2, 2), 2, 4), ("ens_dp_pp", (1, 2, 2), 4, 2))


def replicas_equal(block, stage_split, mesh) -> bool:
    """Whether this rank's leaves replicated over the stages equal stage
    0's bitwise (stage 0's copy broadcast over the pipe group)."""
    first = (0 if mesh.pipe.group is dist.group.WORLD
             else dist.get_global_rank(mesh.pipe.group, 0))
    same = True
    for x, split in zip(pop.tree_leaves(block), stage_split):
        if split:
            continue
        y = x.clone()
        dist.broadcast(y, first, group=mesh.pipe.group)
        same = same and bool(torch.equal(x, y))
        del y
    return same


def verdict_everywhere(rank: int, verdict: str, what: str) -> None:
    """Rank 0's verdict reaches every rank before anyone fails."""
    flags = [None] * WORLD
    dist.all_gather_object(flags, verdict)
    if flags[0] != "ok":
        fail(f"{what}: {flags[0]}")


def pipe_engine(rank: int, dev, cfg) -> dict:
    """Part 5 (a): the pipelined engine on the 4-layer cut against world
    1, and WASH's permutation on the stages."""
    task = make_lm_task(fold_in(0, 1), vocab=min(cfg.vocab_size, 512),
                        device=dev)
    fns = M.pipeline_stage_fns(cfg)
    tpl = M.param_shapes(cfg)

    def data_fn(m, step, s):
        return {"tokens": sample_tokens(task, s, 4, 64)}

    def train(mcfg, n, steps, mesh, micro=None):
        tcfg = TrainConfig(population=n, optimizer="sgd", lr=0.05,
                           total_steps=steps, seed=0)
        engine.reset_chunk_trace_count()
        init = lambda s: M.init_params(cfg, seed=s, device=dev)  # noqa: E731
        if micro is None:  # world 1
            return engine.train_population_sharded(
                0, init, lambda p, b: M.loss_fn(p, cfg, b)[0], data_fn,
                tcfg, mcfg, cfg.num_layers, record_every=steps, mesh=mesh,
                device=dev.type)
        return engine.train_population_pipelined(
            0, init, fns, data_fn, tcfg, mcfg, cfg.num_layers,
            record_every=steps, mesh=mesh, microbatches=micro,
            member_tpl=tpl, device=dev.type)

    meshes = {(kind, shape, n): make_host_mesh(n, kind, mesh_shape=shape,
                                               device=dev.type)
              for kind, shape, n, _ in PIPE_MESHES}  # every rank, in order
    out = {}
    for n in (2, 4):
        for kind, mcfg in (("papa", MixingConfig(kind="papa", papa_every=2)),
                           ("none", MixingConfig(kind="none"))):
            ref = None
            if rank == 0:
                res = train(mcfg, n, 3, EnsMesh(0, 1, n, 0, dev))
                ref = (res.population, res.history["loss"], res.comm_scalars)
                del res
            for mkind, shape, nn, micro in PIPE_MESHES:
                if nn != n:
                    continue
                mesh = meshes[mkind, shape, n]
                t0 = time.perf_counter()
                res = train(mcfg, n, 3, mesh, micro)
                wall = time.perf_counter() - t0
                full = pop.gather_population(res.population, mesh,
                                             stage_split=res.stage_split)
                verdict = "ok"
                try:  # a failure on rank 0 reaches every rank below
                    if rank == 0:
                        close = all(held(a, b, "close", atol=2e-6) for a, b in
                                    zip(pop.tree_leaves(full),
                                        pop.tree_leaves(ref[0])))
                        loss_ok = bool(np.allclose(res.history["loss"],
                                                   ref[1], rtol=2e-5,
                                                   atol=2e-6))
                        if not (close and loss_ok):
                            verdict = (f"params close {close}, losses "
                                       f"{res.history['loss']} vs {ref[1]}")
                        elif res.comm_scalars != ref[2]:
                            verdict = f"comm {res.comm_scalars} vs {ref[2]}"
                        out[f"{kind} N={n} {mkind} {shape} M={micro}"] = {
                            "verdict": verdict, "s": wall,
                            "losses": res.history["loss"],
                            "world_1_losses": ref[1],
                            "chunk_functions": engine.chunk_trace_count()}
                except Exception as e:  # noqa: BLE001 (reported, then failed)
                    verdict = f"{type(e).__name__}: {e}"[:500]
                verdict_everywhere(rank, verdict, f"pipeline, {kind}, "
                                   f"{shape}, M={micro}")
                del res, full
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            del ref
    wash = MixingConfig(kind="wash", base_p=P, mode="bucketed")
    for mkind, shape, n, micro in PIPE_MESHES[:2]:
        mesh = meshes[mkind, shape, n]
        res0 = train(MixingConfig(kind="none"), n, 1, mesh, micro)
        base = pop.gather_population(res0.population, mesh,
                                     stage_split=res0.stage_split)
        del res0
        res = train(wash, n, 1, mesh, micro)
        full = pop.gather_population(res.population, mesh,
                                     stage_split=res.stage_split)
        same = replicas_equal(res.population, res.stage_split, mesh)
        flags = [None] * WORLD
        dist.all_gather_object(flags, same)
        verdict = "ok" if all(flags) else "replicated leaves differ"
        if rank == 0 and verdict == "ok":
            pairs = list(zip(pop.tree_leaves(full), pop.tree_leaves(base)))
            if not all(held(a, b, "permuted") for a, b in pairs):
                verdict = "a leaf is no permutation of the unmixed step's"
            elif all(held(a, b, "equal") for a, b in pairs):
                verdict = "WASH moved nothing"
            out[f"wash N={n} {mkind} {shape} M={micro}"] = {
                "verdict": verdict, "comm": res.comm_scalars,
                "chunk_functions": engine.chunk_trace_count()}
        verdict_everywhere(rank, verdict, f"pipeline, wash, {shape}")
        del res, full, base
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def checked_bucketed(counts: dict):
    """Every bucketed shuffle also through its plain version on the same
    inputs, bitwise; ``counts`` tallies the comparisons."""
    route = ops.bucketed_shuffle_

    def checked(x, idx):
        want = ref.bucketed_shuffle_ref(x, idx)
        route(x, idx)
        if not torch.equal(x, want):
            fail("pipeline: a bucketed shuffle differs from its plain "
                 "version")
        counts["checked"] += 1
        return x

    ops.bucketed_shuffle_ = checked
    try:
        yield
    finally:
        ops.bucketed_shuffle_ = route


def pipe_full_width(rank: int, dev, shape, small: bool) -> dict:
    """Part 5 (b) and (c): full-width llama3.2-3b on an ``ens_pp`` mesh of
    ``shape`` through the train CLI, M = 4."""
    S, n, micro, steps, seq = shape[1], 2, 4, 4, 16 if small else 256
    argv = ["--arch", "llama3.2-3b", "--population", str(n), "--mixing",
            "wash", "--mode", "bucketed", "--base-p", str(P), "--optimizer",
            "sgd", "--steps", str(steps), "--batch-size", "4", "--seq-len",
            str(seq), "--record-every", "1", "--lr", "0.01", "--device",
            dev.type, "--engine", "shard_map", "--mesh", "ens_pp",
            "--mesh-shape", ",".join(map(str, shape)), "--microbatches",
            str(micro)]
    base = get_arch("llama3.2-3b")
    cfg = base.reduced(num_layers=4) if small else base
    shapes = M.param_shapes(cfg)
    lids = tli.infer_layer_ids(shapes, cfg.num_layers)
    layout = types.SimpleNamespace(axis_names=("ens", "pipe"),
                                   shape={"ens": shape[0], "pipe": S})
    pplan = shardplan.plan_population_mixing(
        layout, shapes, rules.stage_member_specs(
            pop.tree_map(lambda _: rules.P(), shapes), lids),
        MixingConfig(kind="wash", base_p=P, mode="bucketed"), lids,
        tli.total_layers(cfg.num_layers), n)
    static = shardplan.static_shard_mix_comm(pplan)
    stages = [shardplan.static_stage_mix_comm(pplan, s) for s in range(S)]
    train_peak = {}
    real_gather = train_cli.gather_population

    def gather(block, mesh, **k):  # the training's peak, before the gather
        if dev.type == "cuda":
            sync(dev)
            train_peak["gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        train_peak["replicas_equal"] = replicas_equal(
            block, k["stage_split"], mesh)
        return real_gather(block, mesh, **k)

    counts = {"checked": 0}
    ws.bucketed_launches = 0
    train_cli.gather_population = gather
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with checked_bucketed(counts):
            res = train_cli.main(argv, cfg=cfg)
        sync(dev)
    finally:
        train_cli.gather_population = real_gather
    comm = np.diff([0.0] + res.history["comm"]).tolist()
    if comm != [static] * steps:
        fail(f"pipeline full width {shape}: comm a step {comm}, the "
             f"planner's {static}")
    if dev.type == "cuda" and counts["checked"] != ws.bucketed_launches:
        fail(f"pipeline full width {shape}: {ws.bucketed_launches} launches, "
             f"{counts['checked']} checked")
    mine = {p: [round(v, 3) for v in res.phase_ms[p]] for p in res.phase_ms}
    ticks = [f + b for f, b in zip(res.phase_ms["fwd_ticks"],
                                   res.phase_ms["bwd_ticks"])]
    mine["bubble_steps_2_on"] = 1.0 - (sum(res.phase_ms["stage_compute"][1:])
                                       / sum(ticks[1:]))
    mine["bucketed_launches"] = ws.bucketed_launches  # 0 on the CPU
    mine["bucketed_checked"] = counts["checked"]
    mine["peak_train_gib"] = train_peak.get("gib")
    mine["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                        if dev.type == "cuda" else None)
    mine["wall_s"] = res.history["wall_s"][0]
    mine["replicas_equal"] = train_peak["replicas_equal"]
    each = [None] * WORLD
    dist.all_gather_object(each, mine)
    if not all(e["replicas_equal"] for e in each):
        fail(f"pipeline full width {shape}: the replicated leaves differ "
             f"across the stages")
    tokens = steps * n * 4 * seq
    out = {"mesh": list(shape), "microbatches": micro,
           "comm_a_step": static, "stage_comm": stages,
           "schedule_bubble": (S - 1) / (micro + S - 1),
           "losses": res.history["loss"], "tokens": tokens,
           "tok_s": tokens / max(e["wall_s"] for e in each), "ranks": each}
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def timed_request(params, cfg, batch, mode, dev, mesh=None,
                  temperature=0.0, new=32):
    """A request served twice through ``engine.generate``: the first
    builds the programs (and, on a mesh, NCCL's communicators); the
    second is timed.  Returns (its tokens, {prefill_s, decode_step_ms,
    wall_s, tok_s, peak_gib}); the peak is the card's from the second
    request's start (the weights and what the request adds)."""
    def request(timings=None):
        return serving.generate(params, cfg, batch, new,
                                temperature=temperature,
                                seed=7 if temperature > 0 else None,
                                mode=mode, device=dev, timings=timings,
                                mesh=mesh)

    request()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    split = {}
    t0 = time.perf_counter()
    out = request(split)
    sync(dev)
    wall = time.perf_counter() - t0
    return out, {"prefill_s": split["prefill_s"],
                 "decode_step_ms": split["decode_s"] * 1e3 / (new - 1),
                 "wall_s": wall,
                 "tok_s": batch["tokens"].shape[0] * new / wall,
                 "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                              if dev.type == "cuda" else None)}


def host_profile(fn, dev, top: int = 8) -> dict:
    """``fn()`` under ``torch.profiler``: the host's wall ms, and the ops
    with the most self host time (ms and calls), so an op in which the
    host waits shows."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    sync(dev)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms": wall, "host_self_ms": {
        e.key: [round(e.self_cpu_time_total / 1e3, 3), e.count]
        for e in ops[:top]}}


def serve_cut(rank: int, dev, cfg, groups) -> dict:
    """Part 6 (a): the cut's soup staged over 4 and 2 ranks and on the
    data mesh of 4, each rank's tokens against its world-1 run; the serve
    CLI over the 4 ranks against the CLI without a mesh."""
    popn = serve_cli.init_population(cfg, 2, 0, dev)
    soup = averaging.uniform_soup(popn)
    meshes = {4: make_host_pipe_mesh(4, dev),
              2: make_host_pipe_mesh(2, dev, group=groups[1][rank // 2]),
              "data": make_host_data_mesh(dev)}
    runs = [("pp4", 4, 4, "soup", 0.0), ("pp4_t", 4, 4, "soup", 0.8),
            ("pp2", 2, 4, "soup", 0.0), ("pp2_t", 2, 4, "soup", 0.8),
            ("data_b8", "data", 8, "soup", 0.0),
            ("data_b8_t", "data", 8, "soup", 0.8),
            ("data_b8_ens", "data", 8, "ensemble", 0.0),
            ("data_b6", "data", 6, "soup", 0.0)]
    verdicts = {}
    for tag, mesh, b, mode, temp in runs:
        batch = concrete_batch(cfg, fold_in(0, 2), b, 64, device=dev)
        params = popn if mode == "ensemble" else soup
        want, _ = timed_request(params, cfg, batch, mode, dev,
                                temperature=temp, new=8)
        got, _ = timed_request(params, cfg, batch, mode, dev, meshes[mesh],
                               temperature=temp, new=8)
        verdicts[tag] = bool(torch.equal(got, want))
    argv = ["--arch", "llama3.2-3b", "--population", "2", "--batch-size",
            "4", "--seq-len", "64", "--max-new", "8", "--device", dev.type]
    with contextlib.redirect_stdout(sys.stdout if rank == 0 else None):
        plain = serve_cli.main(argv, cfg=cfg)["soup"]["tokens"]
        for extra in (["--pp-stages", "4"], ["--mesh", "data"]):
            got = serve_cli.main(argv + extra, cfg=cfg)["soup"]["tokens"]
            verdicts["cli " + " ".join(extra)] = bool(torch.equal(got, plain))
    each = [None] * WORLD
    dist.all_gather_object(each, verdicts)
    bad = sorted({k for e in each for k, v in e.items() if not v})
    verdict_everywhere(rank, "ok" if not bad else f"differ from world 1: "
                       f"{bad}", "serving the cut")
    del popn, soup
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"config": cfg.name, "runs": sorted(verdicts),
            "bitwise_on_every_rank": True}


def weights_gib(params) -> float:
    return sum(x.numel() * x.element_size()
               for x in pop.tree_leaves(params)) / 2**30


def serve_full(rank: int, dev, small: bool, groups) -> dict:
    """Part 6 (b): full-width llama3.2-3b's soup at world 1 and staged
    over 4 and 2 ranks; the data mesh of 4 at B = 16, ensemble and
    soup."""
    base = get_arch("llama3.2-3b")
    cfg = base.reduced(num_layers=4) if small else base
    seq = 32 if small else 2048
    out = {"config": cfg.name, "prompt": seq}
    batch = concrete_batch(cfg, fold_in(0, 2), 4, seq, device=dev)
    soup = averaging.uniform_soup(serve_cli.init_population(cfg, 2, 0, dev))
    if dev.type == "cuda":  # the population is gone: only the soup is held
        torch.cuda.empty_cache()
    want, world1 = timed_request(soup, cfg, batch, "soup", dev)
    world1["weights_gib"] = weights_gib(soup)
    world1["profile"] = host_profile(lambda: serving.generate(
        soup, cfg, batch, 32, device=dev), dev)
    del soup
    mine = {"world1": world1}
    for stages in (4, 2):
        mesh = (make_host_pipe_mesh(4, dev) if stages == 4 else
                make_host_pipe_mesh(2, dev, group=groups[1][rank // 2]))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        soup = averaging.uniform_soup(serve_cli.init_population(
            cfg, 2, 0, dev, mesh))
        draw = None  # the peak of drawing the stage's population
        if dev.type == "cuda":
            draw = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.empty_cache()
        got, m = timed_request(soup, cfg, batch, "soup", dev, mesh)
        m.update(weights_gib=weights_gib(soup), draw_peak_gib=draw,
                 stage=mesh.stage, tokens_equal=bool(torch.equal(got, want)))
        if stages == 4:  # where a stage's host spends a request
            m["profile"] = host_profile(lambda: serving.generate(
                soup, cfg, batch, 32, device=dev, mesh=mesh), dev)
        mine[f"pp{stages}"] = m
        del soup
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dmesh = make_host_data_mesh(dev)
    popn = serve_cli.init_population(cfg, 2, 0, dev)
    big = concrete_batch(cfg, fold_in(0, 2), 16, seq, device=dev)
    rows = slice(4 * rank, 4 * rank + 4)
    for mode in ("ensemble", "soup"):  # the soup is made in place, last
        params = popn if mode == "ensemble" else averaging.uniform_soup_(popn)
        got, m = timed_request(params, cfg, big, mode, dev, dmesh)
        one, m1 = timed_request(params, cfg, big, mode, dev)
        mine_rows, _ = timed_request(
            params, cfg, {k: v[rows] for k, v in big.items()}, mode, dev)
        m.update(rows_equal=bool(torch.equal(got[rows], mine_rows)),
                 one_card_agreement=float(
                     (got[:, seq:] == one[:, seq:]).float().mean()),
                 one_card=m1)
        mine[f"data_{mode}"] = m
    del popn, params
    each = [None] * WORLD
    dist.all_gather_object(each, mine)
    bad = [(r, k) for r, e in enumerate(each) for k, v in e.items()
           if v.get("tokens_equal") is False or v.get("rows_equal") is False]
    verdict_everywhere(rank, "ok" if not bad else f"tokens differ: {bad}",
                       "serving at full width")
    out["ranks"] = each
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    args = build_parser().parse_args()
    parts = {int(p) for p in args.parts.split(",")}
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != WORLD:
        print(f"ensemble_ranks: needs {WORLD} ranks under torchrun, got "
              f"{world}", file=sys.stderr)
        return 2
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    if args.device == "cuda":
        if torch.cuda.device_count() < WORLD:
            print(f"ensemble_ranks: {torch.cuda.device_count()} card(s), "
                  f"needs {WORLD}", file=sys.stderr)
            return 2
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=180))
    try:
        card = None
        if dev.type == "cuda" and rank == 0:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip()
        groups = subgroups()
        base = get_arch("llama3.2-3b")
        small = base.reduced()
        cut = (small if args.small else dataclasses.replace(
            base, num_layers=4, dtype="float32",
            name=f"{base.name}-4layers-f32"))
        t0 = time.perf_counter()
        res = {"device": dev.type, "world": WORLD, "torch": torch.__version__}
        runs = [  # (part, result key, run); part 4 (c) first: a fresh card
            (4, "one_card", lambda: one_card(rank, dev, "llama3.2-3b",
                                             args.small)),
            (1, "ring", lambda: ring(rank, dev, small if args.small else base,
                                     groups)),
            (2, "engine", lambda: engine_worlds(rank, dev, cut, groups)),
            (3, "full_width", lambda: full_width(rank, dev, "llama3.2-3b",
                                                 args.small)),
            (4, "meshes", lambda: mesh_engine(rank, dev, cut)),
            (4, "mesh_full_width", lambda: mesh_full_width(
                rank, dev, "llama3.2-3b", args.small)),
            (5, "pipeline", lambda: pipe_engine(
                rank, dev, base.reduced(num_layers=4) if args.small
                else cut)),
            (5, "pipeline_full_width_1x4", lambda: pipe_full_width(
                rank, dev, (1, 4), args.small)),
            (5, "pipeline_full_width_2x2", lambda: pipe_full_width(
                rank, dev, (2, 2), args.small)),
            (6, "serving", lambda: serve_cut(
                rank, dev, base.reduced(num_layers=4) if args.small
                else cut, groups)),
            (6, "serving_full_width", lambda: serve_full(
                rank, dev, args.small, groups)),
        ]
        for part, key, run in runs:
            if part in parts:
                res[key] = run()
                say(rank, f"{key}: {json.dumps(res[key])}")
        res["seconds"] = time.perf_counter() - t0
        dist.barrier()
        if rank == 0:
            if card:
                print(card)
            print(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
