"""Dry run: roofline terms and per-card bytes of every (arch x shape x
mesh) pair, counted on ``meta`` tensors.

Port of ``repro/launch/dryrun.py``.  This is the one entry point of the
port that needs no card: it allocates on ``meta`` only (shapes and
dtypes, no storage), so a 1T-parameter model at 500k tokens is counted
on a laptop CPU in seconds.  Where the reference lowers and compiles
for 256 or 512 placeholder devices, the port runs its own step eagerly
on meta tensors, through :class:`repro_torch.launch.op_stats.
StepCounter`, as rank 0 of a mesh that does not exist: the mesh is a
layout of axis names and sizes whose process groups are stand-ins
(``core/collectives.py``'s dry mode records what rank 0 would issue and
issues nothing).

Per pair it reports what the port does on that mesh, not what an SPMD
compiler would do:

* training: each card holds its block of member shards (the specs
  ``sharding/rules.py`` gives, plus their AdamW moments), gathers each
  member whole for its forward and backward on the rows of its data
  ranks, averages the gradient over the data ranks, updates its shard,
  then mixes shard-locally (the engine's ``grads_of``, members in turn);
* serving (prefill, decode): the port serves no tensor-parallel layout,
  so each card holds the whole model and its rows of the batch (split
  over the data axes where they divide, as ``rules.batch_pspecs`` says)
  and their cache; the model axis adds no work of its own.

The port's layers run as a Python loop and meta costs no compute, so the
full depth is counted directly (no depth-1 / depth-2 extrapolation, no
``--full-unroll``).  The port has no layout hints (``--hints`` is
refused).  A pair the port cannot count is written with ``status:
error`` and the call that stopped it, never skipped silently.

Usage:
  python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k \
      --wash 2 --multi-pod
  python -m repro_torch.launch.dryrun --pp-stages 4 --arch llama3.2-3b \
      --wash 2
  python -m repro_torch.launch.dryrun --all --out-dir build/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import traceback
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ARCHS, INPUT_SHAPES_BY_NAME, get_arch
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import collectives as coll
from repro_torch.core import population as pop
from repro_torch.core import shardplan
from repro_torch.core.layer_index import infer_layer_ids, total_layers
from repro_torch.core.mixing import MixingConfig, mix_once
from repro_torch.launch import op_stats
from repro_torch.launch.mesh import AxisGroup, EnsMesh, HostMesh
from repro_torch.launch.specs import META, input_specs
from repro_torch.models import transformer as M
from repro_torch.optim import make_optimizer
from repro_torch.sharding import rules
from repro_torch.train.engine import _mean_over
from repro_torch.train.loop import _grad_step

Tree = Any

# dense archs get an explicit sliding-window variant for long_500k
SWA_WINDOW = 8192
LONG_OK_FAMILIES = ("ssm", "hybrid")
LONG_SKIP = {
    "whisper-medium": "enc-dec full-attention decoder; 500k decode out of family",
    "deepseek-v2-lite-16b": "MLA latent cache is full attention over 500k (no SWA claim)",
    "kimi-k2-1t-a32b": "full-attention MoE; no sub-quadratic variant claimed",
    "internvl2-76b": "full-attention VLM backbone; long-context not in scope",
}

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
LR = 3e-4


def variant_for(cfg: ModelConfig, shape: InputShape):
    """Returns (cfg, note) or (None, skip_reason)."""
    if shape.name != "long_500k":
        return cfg, ""
    if cfg.name in LONG_SKIP:
        return None, LONG_SKIP[cfg.name]
    if cfg.family in LONG_OK_FAMILIES:
        return cfg, "sub-quadratic native (SSM state / SWA)"
    return (dataclasses.replace(cfg, window=SWA_WINDOW),
            f"SWA variant (window={SWA_WINDOW})")


def depth_variant(cfg: ModelConfig, d: int) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=d,
                               encoder_layers=d if cfg.is_encdec else 0,
                               scan_unroll=d)


def params_shapes(cfg: ModelConfig) -> Tree:
    return M.param_shapes(cfg)


def opt_shapes(params: Tree, optimizer: str) -> Tree:
    init, _ = make_optimizer(optimizer)
    return init(params)


def _count(tree: Tree) -> int:
    return sum(int(x.numel()) for x in pop.tree_leaves(tree))


def _bytes(tree: Tree) -> int:
    return sum(x.numel() * x.element_size() for x in pop.tree_leaves(tree))


def active_params(cfg: ModelConfig, params: Tree) -> int:
    """N_active for the 6·N·D rule: routed experts count top_k/E."""
    total = _count(params)
    if not cfg.moe:
        return total

    def routed(tree, inside=False):
        if isinstance(tree, dict):
            return sum(routed(v, inside or k == "experts")
                       for k, v in tree.items())
        return int(tree.numel()) if inside else 0

    r = routed(params)
    return total - r + r * cfg.top_k // max(cfg.n_routed_experts, 1)


# ---------------------------------------------------------------------------
# the mesh that does not exist
# ---------------------------------------------------------------------------


def mesh_sizes(wash: int, multi_pod: bool) -> Dict[str, int]:
    """The reference's dry-run layouts, with the population axis the
    port's planner reads: 16 x 16 (2 x 16 x 16 multi-pod) data x model,
    under WASH (ens, data, model) with the population over the ens axis
    (the multi-pod population of 2 is the pod axis)."""
    if wash:
        if multi_pod:
            if wash != 2:
                raise ValueError("multi-pod ensemble maps members onto 2 pods")
            return {"ens": 2, "data": 16, "model": 16}
        if 256 % (wash * 16):
            raise ValueError("population must divide the data axis")
        return {"ens": wash, "data": 256 // (wash * 16), "model": 16}
    if multi_pod:
        return {"ens": 1, "pod": 2, "data": 16, "model": 16}
    return {"ens": 1, "data": 16, "model": 16}


def _dry_group(names, sizes, coords, axes) -> AxisGroup:
    """The axis group of the ranks that share ``coords`` off ``axes``
    (``launch/mesh.py``'s row-major numbering), with a stand-in group
    that carries their global ranks."""
    axes = tuple(a for a in names if a in axes)
    size = int(np.prod([sizes[a] for a in axes])) if axes else 1
    pos = 0
    for a in axes:
        pos = pos * sizes[a] + coords[a]
    if size == 1:
        return AxisGroup(axes, 0, 1, None)
    ranks = []
    for on in itertools.product(*(range(sizes[a]) for a in axes)):
        c = {**coords, **dict(zip(axes, on))}
        r = 0
        for a in names:
            r = r * sizes[a] + c[a]
        ranks.append(r)
    return AxisGroup(axes, pos, size, coll.DryGroup(tuple(ranks)))


def dry_host_mesh(sizes: Dict[str, int], population: int,
                  rank: int = 0) -> HostMesh:
    """Rank ``rank``'s :class:`HostMesh` on the layout ``sizes``, on
    ``meta``, its groups stand-ins (``coll.DryGroup``)."""
    names = tuple(sizes)
    roles = shardplan.classify_roles(
        SimpleNamespace(axis_names=names, shape=sizes), population)
    coords, r = {}, rank
    for a in reversed(names):
        r, coords[a] = divmod(r, sizes[a])
    coords = {a: coords[a] for a in names}
    group = lambda axes: _dry_group(names, sizes, coords, axes)  # noqa: E731
    pop_g = group(roles.pop_axes)
    n_local = population // pop_g.world
    ens = EnsMesh(rank=pop_g.rank, world=pop_g.world, n_local=n_local,
                  member_offset=pop_g.rank * n_local, device=META,
                  group=pop_g.group)
    return HostMesh(axis_names=names, shape=dict(sizes), coords=coords,
                    roles=roles, rank=rank, device=META, pop=ens,
                    data=group(roles.dp_axes), model=group(roles.model_axes),
                    loss=group(roles.pop_axes + roles.dp_axes))


# ---------------------------------------------------------------------------
# step builders (the port's own loss, prefill, decode, mixing, optimizer)
# ---------------------------------------------------------------------------


def _member_grads(cfg: ModelConfig, population: Tree, m: int, batch,
                  mesh: Optional[HostMesh], pplan) -> Tuple[Any, Tree]:
    """Member ``m``'s loss and gradient as the engine takes them
    (``train/engine.py``'s ``grads_of``): gathered whole over the model
    ranks, its gradient averaged over the data ranks, then sliced back
    to this rank's shard."""
    loss_fn = lambda p, b: M.loss_fn(p, cfg, b)[0]  # noqa: E731
    if pplan is None or not (pplan.any_sharded or pplan.dp_axes):
        return _grad_step(loss_fn, pop.member(population, m), batch)
    full = pop.member(shardplan.all_gather_population(
        pop.tree_map(lambda x: x[m:m + 1], population), pplan, mesh), 0)
    loss, grads = _grad_step(loss_fn, full, batch)
    del full
    grads = pop.tree_map(lambda g: _mean_over(g, mesh.data).unsqueeze(0),
                         grads)
    return loss, pop.member(shardplan.shard_population(grads, pplan, mesh),
                            0)


def make_prefill_step(cfg: ModelConfig, capacity: int) -> Callable:
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, capacity=capacity)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, tokens, cache, pos: int):
        return M.decode_step(params, cfg, tokens, cache, pos)

    return serve_step


def make_wash_step(cfg: ModelConfig, n: int, mcfg: MixingConfig,
                   optimizer: str = "adamw", mix_fn=None, mesh=None,
                   pplan=None) -> Callable:
    """A population step as the port runs it (one model's training step
    is this at a population of one, ``mcfg.kind == "none"``, as the
    engine takes it): this card's members in
    turn (forward, backward, optimizer update, in place), then one mixing
    step: ``mix_fn(pop, opt, seed)`` when given (the shard-local mixer),
    the engine's shard-local mixing on a mesh (``pplan``), else the
    loop's ``mix_once``.  ``wash_step(population, opt_state, batches,
    seed) -> (population, opt_state, loss, comm)``."""
    _, opt_update = make_optimizer(optimizer)
    lids = tl = None

    def wash_step(population, opt_state, batches, seed: int):
        nonlocal lids, tl
        losses = []
        for m, batch in enumerate(batches):
            loss_m, grads = _member_grads(cfg, population, m, batch, mesh,
                                          pplan)
            opt_update(pop.member(population, m), grads,
                       pop.member(opt_state, m), LR)
            losses.append(loss_m)
            del grads
        loss = torch.mean(torch.stack(losses).float())
        comm = 0.0
        if mcfg.kind == "none":
            return population, opt_state, loss, comm
        if mix_fn is not None:
            population, opt_state, comm = mix_fn(population, opt_state, seed)
        elif pplan is not None:
            shardplan.mix_collective_sharded(seed, population, opt_state,
                                             mcfg, pplan, mesh, True)
            comm = shardplan.static_shard_mix_comm(pplan, opt_state=opt_state)
        else:
            if lids is None:
                member = pop.member(population, 0)
                lids = infer_layer_ids(member, cfg.num_layers)
                tl = total_layers(cfg.num_layers)
            population, opt_state, comm = mix_once(
                seed, population, opt_state, mcfg, lids, tl)
        return population, opt_state, loss, comm

    return wash_step


# ---------------------------------------------------------------------------
# accounting one step
# ---------------------------------------------------------------------------


def _rows(batch: int, mesh: HostMesh, axes) -> int:
    """A card's rows of ``batch`` split over ``axes`` (all when they do
    not divide it, as the specs replicate then)."""
    nd = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    return batch // nd if nd and batch % nd == 0 else batch


def _block(params: Tree, pplan, n_local: int) -> Tree:
    """A card's block of member shards on meta, ``(n_local, *shard)``."""
    if pplan is None:
        return pop.tree_map(lambda x: torch.empty(
            (n_local,) + tuple(x.shape), dtype=x.dtype, device=META), params)
    it = iter(pplan.infos)
    return pop.tree_map(lambda x: torch.empty(
        (n_local,) + tuple(next(it).local_shape), dtype=x.dtype,
        device=META), params)


def _opt_block(block: Tree, optimizer: str, n_local: int) -> Tree:
    state = opt_shapes(block, optimizer)
    state["step"] = torch.empty((n_local,), dtype=torch.int32, device=META)
    return state


def account_train(cfg: ModelConfig, batch: int, seq: int, sizes: Dict[str, int],
                  population: int, mcfg: MixingConfig,
                  optimizer: str = "adamw", local_mixer: bool = False
                  ) -> Dict[str, Any]:
    """One population training step of ``population`` members at
    ``batch`` rows x ``seq`` tokens a member, on the layout ``sizes``, as
    rank 0 runs it.  Returns the counter's figures, the recorded
    collectives and the card's resident bytes."""
    params = params_shapes(cfg)
    mesh = dry_host_mesh(sizes, population)
    world = int(np.prod(list(sizes.values())))
    pplan = None
    if world > 1:
        lids = infer_layer_ids(params, cfg.num_layers)
        specs = rules.param_pspecs(params, cfg, mesh)
        pplan = shardplan.plan_population_mixing(
            mesh, params, specs, mcfg, lids, total_layers(cfg.num_layers),
            population)
    n_local = mesh.n_local
    rows = _rows(batch, mesh, pplan.dp_axes if pplan is not None else ())
    block = _block(params, pplan, n_local)
    opt = _opt_block(block, optimizer, n_local)
    resident = _bytes(block) + _bytes(opt)
    mix_fn = None
    if local_mixer and pplan is not None:
        pop_specs = rules.population_pspecs(rules.param_pspecs(
            params, cfg, mesh), pplan.pop_axes)
        mix_fn = shardplan.make_shardlocal_mixer(
            mesh, mcfg, cfg.num_layers, pop_specs,
            rules.opt_pspecs(opt, pop_specs, pplan.pop_axes))
    step = make_wash_step(cfg, population, mcfg, optimizer, mix_fn=mix_fn,
                          mesh=mesh, pplan=pplan)
    batches = [input_specs(cfg, InputShape("member", seq, rows, "train"))
               for _ in range(n_local)]
    with coll.record(dry_rank=0) as events, op_stats.StepCounter() as c:
        _, _, _, comm = step(block, opt, batches, 0)
    return {"counter": c, "events": list(events), "resident": resident,
            "rows": rows, "n_local": n_local, "mesh": mesh, "pplan": pplan,
            "comm_scalars": float(comm) / (population if mix_fn else 1)}


def account_serve(cfg: ModelConfig, shape: InputShape, sizes: Dict[str, int],
                  members: int = 1) -> Dict[str, Any]:
    """One prefill or decode step of ``shape`` on the layout ``sizes``:
    the whole model on each card (``members`` of them, run in turn, as
    the ensemble does), the card's rows over the data axes."""
    params = params_shapes(cfg)
    mesh = SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))
    dax = tuple(a for a in ("pod", "data") if a in sizes)
    rows = _rows(shape.global_batch, mesh, dax)
    local = dataclasses.replace(shape, global_batch=rows)
    specs = input_specs(cfg, local)
    resident = members * _bytes(params)
    if shape.kind == "decode":
        resident += members * _bytes(specs["cache"])
    with coll.record(dry_rank=0) as events, op_stats.StepCounter() as c:
        for _ in range(members):
            if shape.kind == "prefill":
                make_prefill_step(cfg, shape.seq_len)(params, specs)
            else:
                make_serve_step(cfg)(params, specs["tokens"], specs["cache"],
                                     shape.seq_len - 1)
    return {"counter": c, "events": list(events), "resident": resident,
            "rows": rows, "n_local": members, "comm_scalars": 0.0}


def account_request(cfg: ModelConfig, batch: int, seq: int, max_new: int,
                    members: int = 1, held_models: int = 1
                    ) -> Dict[str, Any]:
    """One scan-engine request on one card: the prefill of ``batch``
    prompts of ``seq`` tokens into a cache of ``seq + max_new`` and one
    decode step, for each of ``members`` models in turn (the ensemble),
    with ``held_models`` whole models resident (a population and its
    soup).  Every cache lives to the end, as the ensemble's do."""
    params = params_shapes(cfg)
    tokens = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                    device=META)}
    tokens.update(input_specs(cfg, InputShape("request", seq, batch,
                                              "prefill")))
    caches = []
    with coll.record(dry_rank=0) as events, op_stats.StepCounter() as c:
        for _ in range(members):
            _, cache = make_prefill_step(cfg, seq + max_new)(params, tokens)
            caches.append(cache)
        for cache in caches:
            make_serve_step(cfg)(params, tokens["tokens"][:, :1], cache, seq)
    return {"counter": c, "events": list(events),
            "resident": held_models * _bytes(params), "rows": batch,
            "n_local": members, "comm_scalars": 0.0}


def _record_figures(acc: Dict[str, Any], chips: int) -> Dict[str, Any]:
    c = acc["counter"]
    coll_bytes = op_stats.collective_bytes(acc["events"])
    stats = op_stats.summarize(c.flops, c.bytes, coll_bytes, chips)
    per_card = acc["resident"] + c.peak_bytes
    return {
        **stats,
        "matmul_flops": float(c.matmul_flops),
        "kernels": {k: {"calls": v[0], "bytes": v[1], "operations": v[2]}
                    for k, v in sorted(c.kernels.items())},
        "collective_counts": op_stats.collective_counts(acc["events"]),
        "collective_dtypes": {k: sorted(v) for k, v in
                              op_stats.collective_dtypes(acc["events"]).items()},
        "rows_per_card": acc["rows"],
        "members_per_card": acc["n_local"],
        "resident_bytes": acc["resident"],
        "step_peak_bytes": c.peak_bytes,
        "per_card_bytes": per_card,
        "per_card_gib": per_card / 2 ** 30,
        "fits": op_stats.fits(per_card),
        "aten_ops": c.ops,
        "comm_scalars_per_member": acc["comm_scalars"],
    }


# ---------------------------------------------------------------------------
# planner-only pipeline accounting (no devices)
# ---------------------------------------------------------------------------


def pipeline_report(arch_id: str, population: int, stages: int,
                    mixing_kind: str = "wash") -> dict:
    """Per-stage WASH comm for ``arch`` on an (ens, data, pipe) mesh: the
    planner (``core/shardplan.py``) on a stand-in mesh of axis names and
    sizes.  Asserts the accounting contract: the per-stage volumes sum
    exactly to the pipeline plan's global, which never exceeds the
    single-stage plan's."""
    cfg = get_arch(arch_id)
    params = params_shapes(cfg)
    lids = infer_layer_ids(params, cfg.num_layers)
    tl = total_layers(cfg.num_layers)
    member_specs = pop.tree_map(lambda _: rules.P(), params)
    mcfg = MixingConfig(kind=mixing_kind, base_p=0.05, mode="bucketed")
    mesh = SimpleNamespace(axis_names=("ens", "data", "pipe"),
                           shape={"ens": population, "data": 1,
                                  "pipe": stages})
    staged_specs = rules.stage_member_specs(member_specs, lids, "pipe")
    pplan = shardplan.plan_population_mixing(mesh, params, staged_specs, mcfg,
                                             lids, tl, population)
    per_stage = [shardplan.static_stage_mix_comm(pplan, s)
                 for s in range(stages)]
    total = shardplan.static_shard_mix_comm(pplan)
    mesh1 = SimpleNamespace(axis_names=("ens", "data"),
                            shape={"ens": population, "data": 1})
    plan1 = shardplan.plan_population_mixing(mesh1, params, member_specs,
                                             mcfg, lids, tl, population)
    single = shardplan.static_shard_mix_comm(plan1)
    assert sum(per_stage) == total, (per_stage, total)
    assert total <= single + 1e-6, (total, single)
    return {"arch": arch_id, "population": population, "stages": stages,
            "mixing": mixing_kind, "num_layers": cfg.num_layers,
            "per_stage_scalars": per_stage, "total_scalars": total,
            "single_stage_scalars": single}


# ---------------------------------------------------------------------------
# per-pair orchestration
# ---------------------------------------------------------------------------


def account_pair(arch_id: str, shape_name: str, multi_pod: bool,
                 wash: int = 0, mixing_kind: str = "wash",
                 overrides: Optional[dict] = None,
                 layers: Optional[int] = None) -> Dict[str, Any]:
    """The record of one (arch, shape, mesh) pair (``lower_pair`` of the
    reference).  ``overrides`` are config fields set on top of the arch's
    (``attn_impl``, ``remat_blocks``, ...); ``layers`` cuts the depth
    (:func:`depth_variant`; the record says so)."""
    shape = INPUT_SHAPES_BY_NAME[shape_name]
    cfg, note = variant_for(get_arch(arch_id), shape)
    if cfg is None:
        return {"arch": arch_id, "shape": shape_name, "multi_pod": multi_pod,
                "wash": wash, "status": "skip", "note": note}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if layers:
        cfg = depth_variant(cfg, layers)
    sizes = mesh_sizes(wash, multi_pod)
    chips = int(np.prod(list(sizes.values())))
    params = params_shapes(cfg)
    n_params, n_active = _count(params), active_params(cfg, params)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    if shape.kind == "train":
        local = mixing_kind.endswith("_local")
        kind = mixing_kind[:-6] if local else mixing_kind
        mcfg = MixingConfig(kind=kind if wash else "none", base_p=0.05,
                            mode="bucketed")
        n = max(wash, 1)
        acc = account_train(cfg, shape.global_batch // n, shape.seq_len,
                            sizes, n, mcfg, "adamw", local_mixer=local)
    else:
        acc = account_serve(cfg, shape, sizes)
    mf = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    fig = _record_figures(acc, chips)
    return {
        "arch": arch_id, "shape": shape_name, "mesh": list(sizes.values()),
        "axes": list(sizes), "multi_pod": multi_pod, "wash": wash,
        "mixing": mixing_kind if wash else None, "status": "ok",
        "note": note, "chips": chips, "num_layers": cfg.num_layers,
        "n_params": n_params, "n_active": n_active, "tokens": tokens,
        "model_flops": mf, **fig,
        "useful_flops_ratio": (mf / fig["global_flops"]
                               if fig["global_flops"] else None),
    }


def _stopped_at(exc: BaseException) -> str:
    """The innermost frame of the port's code that ``exc`` came through."""
    frames = traceback.extract_tb(exc.__traceback__)
    ours = [f for f in frames if "repro_torch" in f.filename]
    f = (ours or frames)[-1]
    path = f.filename[f.filename.find("repro_torch"):] if ours else f.filename
    return f"{path}:{f.lineno} {f.name}: {f.line}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry run on meta tensors: roofline terms and per-card "
                    "bytes of every (arch x shape x mesh) pair, no card",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--arch", default=None,
                    help="architecture name from repro_torch.configs (omit "
                         "with --all to sweep every arch)")
    ap.add_argument("--shape", default=None,
                    help="input shape name: train_4k, prefill_32k, "
                         "decode_32k, long_500k (omit with --all to sweep)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 layout instead of the 16x16")
    ap.add_argument("--wash", type=int, default=0,
                    help="population size (ens axis); 0 = one model")
    ap.add_argument("--mixing", default="wash",
                    choices=["wash", "wash_opt", "papa", "papa_all",
                             "wash_local", "wash_opt_local"],
                    help="mixing in the WASH step; *_local through the "
                         "standalone shard-local mixer "
                         "(core.shardplan.make_shardlocal_mixer)")
    ap.add_argument("--pp-stages", type=int, default=0,
                    help="planner-only pipeline report: partition --arch's "
                         "WASH plan into this many stages on a stand-in "
                         "(ens, data, pipe) mesh and print per-stage comm "
                         "(population = --wash, default 4)")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) pair")
    ap.add_argument("--out-dir", default=os.path.join("build", "dryrun"),
                    help="directory for the per-pair JSON records")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every config to this many layers (a quick "
                         "sweep; the records carry num_layers)")
    ap.add_argument("--attn-impl", default=None, choices=["naive", "chunked"],
                    help="override cfg.attn_impl")
    ap.add_argument("--attn-chunk", type=int, default=None,
                    help="override cfg.attn_chunk (kv-chunk size)")
    ap.add_argument("--remat", action="store_true",
                    help="activation-checkpoint each block (training shapes)")
    ap.add_argument("--moe-impl", default=None, choices=["global", "grouped"],
                    help="override cfg.moe_impl for MoE archs")
    ap.add_argument("--hints", action="store_true",
                    help="refused: the port has no layout hints")
    ap.add_argument("--tag", default=None, help="suffix for the output file")
    ap.add_argument("--metrics-out", default=None,
                    help="write the telemetry event stream (a span a pair) "
                         "as JSONL here")
    args = ap.parse_args(argv)
    if args.hints:
        ap.error("--hints: the port has no in-model layout hints (each "
                 "member is gathered whole before its forward)")

    tel = obs.configure(jsonl=args.metrics_out)
    if args.pp_stages:
        if not args.arch:
            ap.error("--pp-stages needs --arch")
        base = (args.mixing[:-6] if args.mixing.endswith("_local")
                else args.mixing)
        rec = pipeline_report(args.arch, args.wash or 4, args.pp_stages, base)
        stages_str = " ".join(f"s{i}={v:.3e}" for i, v in
                              enumerate(rec["per_stage_scalars"]))
        print(f"[pipeline] {rec['arch']} N={rec['population']} "
              f"S={rec['stages']} L={rec['num_layers']}: {stages_str}")
        print(f"[pipeline] total={rec['total_scalars']:.6e} (= sum of "
              f"stages) vs single-stage {rec['single_stage_scalars']:.6e}")
        tel.event("dryrun.pipeline_report", arch=rec["arch"],
                  stages=rec["stages"], total_scalars=rec["total_scalars"])
        tel.finalize()
        return 0

    overrides = {}
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl
    if args.attn_chunk:
        overrides["attn_chunk"] = args.attn_chunk
    if args.remat:
        overrides["remat_blocks"] = True
    if args.moe_impl:
        overrides["moe_impl"] = args.moe_impl

    if args.all:
        pairs = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]
    os.makedirs(args.out_dir, exist_ok=True)
    ok = True
    for aid, sh in pairs:
        tag = (f"{aid}_{sh}_{'mp' if args.multi_pod else 'sp'}"
               + (f"_wash{args.wash}_{args.mixing}" if args.wash else "")
               + (f"_L{args.layers}" if args.layers else "")
               + (f"_{args.tag}" if args.tag else ""))
        path = os.path.join(args.out_dir, tag + ".json")
        try:
            with tel.span("dryrun.account_pair", arch=aid, shape=sh):
                rec = account_pair(aid, sh, args.multi_pod, args.wash,
                                   args.mixing, overrides or None,
                                   args.layers)
            rec["overrides"] = overrides
        except Exception as e:  # noqa: BLE001 (each pair's verdict is kept)
            rec = {"arch": aid, "shape": sh, "multi_pod": args.multi_pod,
                   "wash": args.wash, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "stopped_at": _stopped_at(e),
                   "trace": traceback.format_exc()[-2000:]}
            ok = False
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        if rec["status"] == "ok":
            print(f"[ok] {tag}: compute={rec['compute_s']:.3e}s "
                  f"memory={rec['memory_s']:.3e}s "
                  f"collective={rec['collective_s']:.3e}s "
                  f"dominant={rec['dominant']} "
                  f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)} "
                  f"per-card {rec['per_card_gib']:.2f} GiB "
                  f"fits={rec['fits']}", flush=True)
        elif rec["status"] == "skip":
            print(f"[skip] {tag}: {rec['note']}", flush=True)
        else:
            print(f"[ERROR] {tag}: {rec['error']} at {rec['stopped_at']}",
                  flush=True)
    tel.finalize()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
