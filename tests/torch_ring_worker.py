"""One rank of a gloo group for the ensemble engine's multi-process tests.

    python tests/torch_ring_worker.py SCENARIO RANK WORLD DIR

joins a ``gloo`` group of WORLD processes through a ``FileStore`` in DIR
(nothing on the network), runs SCENARIO on the inputs the parent test
left in ``DIR/in.npz`` and writes this rank's results to
``DIR/out_RANK.npz``.  It imports ``torch`` and ``repro_torch`` only: the
parent computes the JAX package's expectations and compares.  The toy
model (:func:`toy_init`, :func:`toy_loss`, :func:`toy_data`) is the one
the parent trains at world 1.

Scenarios:
  collective  the blocked ring apply on rank subgroups of 1-4 ranks, the
              one-member-a-rank apply, ``mix_collective_blocked`` on the
              parent's plans, the plans each rank draws, and
              ``gather_population``;
  engine      the ensemble engine on the toy model at world 2 (two
              subgroups of 2) and world 4, the population gathered;
  multiaxis   the engine on ens×data×model meshes of the 4 ranks
              (:data:`MX_RUNS`) on the multi-axis toy model
              (:func:`mx_init`, :func:`mx_loss`, :func:`mx_data`, whose
              leaves :func:`mx_specs` split), the population gathered on
              rank 0 and written through ``checkpoint``; each rank's
              shard-local plans; the train CLI on a (2, 1, 2) mesh.
  pipeline    the pipelined engine on (ens, pipe) and (ens, data, pipe)
              meshes of the 4 ranks (:data:`PP_RUNS`) on
              ``tests/test_pipeline.py``'s toy (:data:`PP_STAGE_FNS`,
              :func:`pp_init`, :func:`pp_data`), the population gathered
              on rank 0, each rank's replicated leaves, a population file
              written and restored; the train CLI on a (2, 2) mesh.
  serving     stage-split serving over 4 stages and over 2 (the rank
              pairs [0, 1] and [2, 3]), GQA and MLA, greedy and sampled
              (:data:`SV_RUNS`), a request served twice; the data mesh
              of 4 on split and replicated batches, soup and ensemble,
              and a global-MoE config; an ensemble-engine result of N = 4
              on each pair (two members a rank) through the serving
              functions; the serve CLI with ``--pp-stages 4`` (drawn and
              restored) and ``--mesh data`` (:func:`sv_cli_cfg`).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

TOY_N, TOY_STEPS, TOY_RECORD = 4, 11, 5
# the engine runs across ranks: (name, MixingConfig kwargs)
ENGINE_RUNS = [("wash", dict(kind="wash", base_p=0.5, mode="bucketed")),
               ("papa", dict(kind="papa", papa_every=2, papa_alpha=0.9)),
               ("none", dict(kind="none"))]
# (n, m) of the blocked ring apply: n members over m ranks
RING_CASES = [(4, 1), (4, 2), (4, 4), (6, 3), (8, 2), (8, 4)]
RING_WIDTH = 37  # a multiple of no block
MIX_KINDS = ("wash", "wash_opt", "papa", "papa_all")


def toy_init(seed: int):
    """embed 16x8, one 8x8 block, head 8x4, float32, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return {"embed": {"w": torch.randn(16, 8, generator=g)},
            "blocks": [{"w1": torch.randn(8, 8, generator=g)}],
            "head": {"w": torch.randn(8, 4, generator=g)}}


def toy_loss(p, b):
    h = torch.tanh(b["x"] @ p["embed"]["w"] @ p["blocks"][0]["w1"])
    return torch.mean((h @ p["head"]["w"] - b["y"]) ** 2)


def toy_data(m: int, step: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(4, 16, generator=g),
            "y": torch.randn(4, 4, generator=g)}


def toy_train(mcfg_kw: dict, mesh=None):
    """The engine on the toy model (N = 4, SGD, 11 steps, a record every
    5), on the CPU."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.train import engine

    engine.reset_chunk_trace_count()
    tcfg = TrainConfig(population=TOY_N, optimizer="sgd", lr=0.05,
                       total_steps=TOY_STEPS, batch_size=4)
    return engine.train_population_sharded(
        0, toy_init, toy_loss, toy_data, tcfg, MixingConfig(**mcfg_kw), 1,
        record_every=TOY_RECORD, mesh=mesh, device="cpu")


def flat_tree(tree, prefix=""):
    from repro_torch.core.population import tree_paths

    return {prefix + "/".join(map(str, path)): leaf
            for path, leaf in tree_paths(tree)}


# the rank subgroups of a world of 4, by size: [2, 3] and [1, 2, 3]
# have group ranks that are not their global ranks
GROUPS = {2: [[0, 1], [2, 3]], 3: [[1, 2, 3]], 4: [[0, 1, 2, 3]]}


def _meshes(rank: int):
    """Every group of :data:`GROUPS`, made by every rank in one order:
    ``{m: mesh}`` for the groups this rank is in."""
    from repro_torch.launch.mesh import make_host_ensemble_mesh

    out = {}
    for m, groups in GROUPS.items():
        for g in groups:
            pg = dist.new_group(g)
            if rank in g:
                out[m] = make_host_ensemble_mesh(m, "cpu", group=pg)
    return out


def _ring_mesh(meshes, m: int, n: int):
    """This rank's mesh for n members over m ranks (None: not in one)."""
    from repro_torch.launch.mesh import EnsMesh

    if m == 1:
        return EnsMesh(0, 1, n, 0, torch.device("cpu"))
    mesh = meshes.get(m)
    if mesh is None:
        return None
    return EnsMesh(mesh.rank, m, n // m, mesh.rank * (n // m), mesh.device,
                   mesh.group)


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """A copy of this rank's block of the stacked ``x``."""
    return x[mesh.member_offset:mesh.member_offset + mesh.n_local].clone()


def collective(rank: int, world: int, data) -> dict:
    from repro_torch.core import mixing as mix
    from repro_torch.core import population as pop
    from repro_torch.core import shuffle as shf
    from repro_torch.core.layer_index import infer_layer_ids, total_layers

    out = {}
    meshes = _meshes(rank)
    for n, m in RING_CASES:
        mesh = _ring_mesh(meshes, m, n)
        if mesh is None:
            continue
        for dt in ("float32", "bfloat16"):
            x = torch.from_numpy(data[f"ring_x_{n}"]).to(getattr(torch, dt))
            idx = torch.from_numpy(data[f"ring_idx_{n}"])
            block = _rows(x, mesh)
            shf.apply_plan_collective_blocked([idx], [block], mesh)
            out[f"ring_{n}_{m}_{dt}"] = block.float().numpy()

    # one member a rank, every rank of the world
    mesh = _ring_mesh(meshes, world, world)
    x = torch.from_numpy(data["one_x"])[rank].clone()
    shf.apply_plan_collective({"w": torch.from_numpy(data["one_idx"])},
                              {"w": x}, mesh)
    out["one"] = x.numpy()

    # mixing on the toy tree, two members a rank at world 2 and one at 4
    keys = sorted(k[len("pop/"):] for k in data.files if k.startswith("pop/"))
    for m in (2, 4):
        mesh = _ring_mesh(meshes, m, TOY_N)
        if mesh is None:
            continue

        def block_of(prefix):
            return {k: _rows(torch.from_numpy(data[prefix + k]), mesh)
                    for k in keys}

        for kind in MIX_KINDS:
            params = block_of("pop/")
            moments = {"mu": block_of("mu/"), "nu": block_of("nu/")}
            plan = {k: (torch.from_numpy(data["plan/" + k])
                        if "plan/" + k in data.files else None) for k in keys}
            real = shf.make_plan
            shf.make_plan = lambda *a, **k: plan
            try:
                cfg = mix.MixingConfig(kind=kind, base_p=0.5, mode="bucketed",
                                       papa_alpha=0.9)
                mix.mix_collective_blocked(7, params, moments, cfg,
                                           {k: 0 for k in keys}, 3, mesh, True)
            finally:
                shf.make_plan = real
            for k in keys:
                out[f"mix_{kind}_{m}/p/{k}"] = params[k].numpy()
                out[f"mix_{kind}_{m}/mu/{k}"] = moments["mu"][k].numpy()
                out[f"mix_{kind}_{m}/nu/{k}"] = moments["nu"][k].numpy()

    # the plans every rank draws from one seed on its own member template
    mesh = _ring_mesh(meshes, world, 2 * world)
    member = toy_init(rank)  # different values, the same shapes
    lids = infer_layer_ids(member, 1)
    plan = shf.make_plan(11, member, lids, total_layers(1), 0.5,
                         mode="bucketed", n=2 * world)
    check = torch.tensor([float(sum(int(p.long().sum()) * (i + 1)
                                    for i, p in enumerate(
                                        pop.tree_leaves(plan))
                                    if p is not None))], dtype=torch.float64)
    sums = [torch.zeros_like(check) for _ in range(world)]
    dist.all_gather(sums, check, group=mesh.group)
    out["plan_checksums"] = torch.cat(sums).numpy()

    # the stacked population rebuilt on rank 0
    full = torch.from_numpy(data["gather_x"])
    got = pop.gather_population({"w": _rows(full, mesh)}, mesh)
    if rank == 0:
        out["gathered"] = got["w"].numpy()
    elif got is not None:
        raise AssertionError("gather_population gave a tree off rank 0")
    return out


def engine_runs(rank: int, world: int, data) -> dict:
    from repro_torch.core.population import gather_population

    out = {}
    meshes = _meshes(rank)
    for m in (2, 4):
        if rank >= m:  # in the group of rank 0 only
            continue
        mesh = _ring_mesh(meshes, m, TOY_N)
        for name, kw in ENGINE_RUNS:
            res = toy_train(kw, mesh)
            full = gather_population(res.population, mesh)
            if mesh.rank == 0:
                out.update(flat_tree(full, f"{name}_{m}/"))
                for k in ("loss", "consensus", "comm", "step"):
                    out[f"{name}_{m}/{k}"] = np.asarray(res.history[k])
                out[f"{name}_{m}/offset"] = np.asarray(res.member_offset)
    return out


# the multi-axis toy: tests/test_shardplan.py's MEMBER shapes
MX_STEPS, MX_RECORD = 7, 3
# (tag, mesh shape, N, MixingConfig kwargs, optimizer, steps, record every)
MX_RUNS = [(f"{kind}_{'x'.join(map(str, shape))}_{n}", shape, n,
            dict(kind=kind, papa_every=3, papa_all_every=3, papa_alpha=0.9),
            "sgd", MX_STEPS, MX_RECORD)
           for shape, n in (((2, 1, 2), 2), ((2, 1, 2), 4), ((1, 1, 4), 2),
                            ((2, 2, 1), 4))
           for kind in ("none", "papa", "papa_all")]
MX_RUNS += [(f"{kind}_{'x'.join(map(str, shape))}_{n}", shape, n,
             dict(kind=kind, base_p=0.9, schedule="constant",
                  mode="bucketed"),
             "adamw" if kind == "wash_opt" else "sgd", 1, 1)
            for shape, n in (((2, 1, 2), 2), ((1, 1, 4), 2), ((2, 1, 2), 4))
            for kind in ("wash", "wash_opt")]
MX_RUNS += [("wash_2x2x1_2", (2, 2, 1), 2,
             dict(kind="wash", base_p=0.5, mode="bucketed"), "sgd", 5, 2)]
MX_PLAN_SEED = 11
MX_CLI = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
          "--population", "2", "--mixing", "papa", "--steps", "3",
          "--batch-size", "2", "--seq-len", "8", "--engine", "shard_map"]


def mx_specs():
    from repro_torch.sharding.rules import P

    return {"embed": {"w": P(None, "model")},
            "blocks": {"w1": P(None, None, "model")},
            "head": {"w": P()}}


def mx_init(seed: int):
    """embed 32x16, two stacked 16x64 blocks, head 16x8, float32."""
    g = torch.Generator().manual_seed(seed)
    return {"embed": {"w": 0.3 * torch.randn(32, 16, generator=g)},
            "blocks": {"w1": 0.3 * torch.randn(2, 16, 64, generator=g)},
            "head": {"w": 0.3 * torch.randn(16, 8, generator=g)}}


def mx_loss(p, b):
    h = b["x"] @ p["embed"]["w"]
    for w in p["blocks"]["w1"]:
        h = torch.tanh(h @ w) @ w.T / 8
    return torch.mean((h @ p["head"]["w"] - b["y"]) ** 2)


def mx_data(m: int, step: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(4, 32, generator=g),
            "y": torch.randn(4, 8, generator=g)}


def mx_train(mcfg_kw: dict, optimizer: str, n: int, steps: int, every: int,
             mesh=None, param_specs=None):
    """The engine on the multi-axis toy, on the CPU: at world 1 with
    ``mesh=None``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.train import engine

    engine.reset_chunk_trace_count()
    tcfg = TrainConfig(population=n, optimizer=optimizer,
                       lr=3e-3 if optimizer == "adamw" else 0.05,
                       total_steps=steps, batch_size=4)
    return engine.train_population_sharded(
        0, mx_init, mx_loss, mx_data, tcfg, MixingConfig(**mcfg_kw), 2,
        record_every=every, mesh=mesh, param_specs=param_specs, device="cpu")


def multiaxis(rank: int, world: int, data) -> dict:
    from repro_torch.core import shardplan as sp
    from repro_torch.core.layer_index import infer_layer_ids, total_layers
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.core.population import gather_population
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint, engine

    out = {}
    meshes = {}
    for tag, shape, n, kw, optimizer, steps, every in MX_RUNS:
        if (shape, n) not in meshes:  # every rank makes every mesh, in order
            meshes[shape, n] = make_host_mesh(n, "ens_dp_mp",
                                              mesh_shape=shape, device="cpu")
        mesh = meshes[shape, n]
        res = mx_train(kw, optimizer, n, steps, every, mesh, mx_specs())
        traces = engine.chunk_trace_count()
        full = gather_population(res.population, mesh,
                                 shard_dims=res.shard_dims)
        mu = gather_population(res.opt_state["mu"], mesh,
                               shard_dims=res.shard_dims)
        if rank == 0:
            out.update(flat_tree(full, f"{tag}/p/"))
            out.update(flat_tree(mu, f"{tag}/mu/"))
            for k in ("loss", "consensus", "comm", "step"):
                out[f"{tag}/{k}"] = np.asarray(res.history[k])
            out[f"{tag}/traces"] = np.asarray(traces)
            out[f"{tag}/roles"] = np.asarray(
                [",".join(mesh.roles.pop_axes), ",".join(mesh.roles.dp_axes)])
            if tag.startswith("wash_opt_2x1x2_2"):
                path = checkpoint.save(os.path.join(data["dir"].item(),
                                                    "mx_pop"), full)
                back = checkpoint.restore(path, full)
                out.update(flat_tree(back, f"{tag}/restored/"))

    # this rank's plans on the model-split meshes
    member = {"embed": {"w": torch.empty(32, 16, device="meta")},
              "blocks": {"w1": torch.empty(2, 16, 64, device="meta")},
              "head": {"w": torch.empty(16, 8, device="meta")}}
    for shape in ((2, 1, 2), (1, 1, 4)):
        mesh = meshes[shape, 2]
        pplan = sp.plan_population_mixing(
            mesh, member, mx_specs(),
            MixingConfig(kind="wash", base_p=0.9, schedule="constant",
                         mode="bucketed"),
            infer_layer_ids(member, 2), total_layers(2), 2)
        key = "x".join(map(str, shape))
        for i, plan in enumerate(sp.build_local_plans(MX_PLAN_SEED, pplan,
                                                      mesh)):
            out[f"plan/{key}/{i}"] = plan.numpy()
        out[f"coords/{key}"] = np.asarray([mesh.coords[a] for a in
                                           mesh.axis_names])

    # the train CLI on (2, 1, 2): the model axis from the rules' specs
    train_cli.main(MX_CLI + ["--mesh", "ens_dp_mp", "--mesh-shape", "2,1,2",
                             "--ckpt-population",
                             os.path.join(data["dir"].item(), "cli_pop")])
    return out


# tests/test_pipeline.py's toy: L = 4 stacked 8x8 blocks with a residual
# tanh, embed 16x8, head 8x4, float32, batches of 8
PP_L, PP_STEPS, PP_RECORD = 4, 6, 3
PP_PAPA = dict(kind="papa", papa_every=2, papa_alpha=0.9)
PP_WASH = dict(base_p=0.5, mode="bucketed")
# (tag, mesh kind, mesh shape, N, microbatches, MixingConfig kwargs,
#  optimizer, steps)
PP_RUNS = [(f"{name}_{'x'.join(map(str, shape))}_{n}_m{micro}", kind, shape,
            n, micro, kw, "sgd", PP_STEPS)
           for kind, shape, n, micro in (("ens_pp", (1, 4), 2, 4),
                                         ("ens_pp", (2, 2), 2, 1),
                                         ("ens_pp", (2, 2), 2, 4),
                                         ("ens_dp_pp", (1, 2, 2), 4, 2),
                                         ("ens_dp_pp", (1, 2, 2), 1, 2))
           for name, kw in (("none", dict(kind="none")), ("papa", PP_PAPA))
           if n > 1 or name == "none"]
# WASH and WASH+Opt one step, beside `none` under the same optimizer
PP_RUNS += [(f"{name}_{'x'.join(map(str, shape))}_2_m2", "ens_pp", shape, 2,
             2, kw, optimizer, 1)
            for shape in ((1, 4), (2, 2))
            for name, kw, optimizer in (
                ("wash", dict(kind="wash", **PP_WASH), "sgd"),
                ("wash0", dict(kind="none"), "sgd"),
                ("washopt", dict(kind="wash_opt", **PP_WASH), "adamw"),
                ("washopt0", dict(kind="none"), "adamw"))]
PP_CLI = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
          "--population", "2", "--mixing", "none", "--steps", "3",
          "--batch-size", "2", "--seq-len", "8", "--engine", "shard_map"]


def pp_init(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"embed": {"w": 0.3 * torch.randn(16, 8, generator=g)},
            "blocks": {"w1": 0.3 * torch.randn(PP_L, 8, 8, generator=g)},
            "head": {"w": 0.3 * torch.randn(8, 4, generator=g)}}


def pp_embed(p, b):
    return b["x"] @ p["embed"]["w"]


def pp_blocks(p, x):
    for w in p["blocks"]["w1"].unbind(0):  # this stage's layers
        x = torch.tanh(x @ w) + x
    return x


def pp_head(p, x, b):
    return torch.mean((x @ p["head"]["w"] - b["y"]) ** 2)


def pp_loss(p, b):
    return pp_head(p, pp_blocks(p, pp_embed(p, b)), b)


PP_STAGE_FNS = (pp_embed, pp_blocks, pp_head)


def pp_data(m: int, step: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(8, 16, generator=g),
            "y": torch.randn(8, 4, generator=g)}


def pp_tcfg(n: int, optimizer: str, steps: int):
    from repro_torch.configs.base import TrainConfig

    return TrainConfig(population=n, optimizer=optimizer,
                       lr=3e-3 if optimizer == "adamw" else 0.05,
                       total_steps=steps, batch_size=8)


def pp_train(kw: dict, optimizer: str, n: int, steps: int, mesh=None,
             micro: int = 1):
    """The pipelined engine on the toy, on the CPU (``mesh=None``: the
    world-1 engine, ``train_population_sharded`` on the composed loss)."""
    from repro_torch.core.mixing import MixingConfig
    from repro_torch.train import engine

    engine.reset_chunk_trace_count()
    if mesh is None:
        return engine.train_population_sharded(
            0, pp_init, pp_loss, pp_data, pp_tcfg(n, optimizer, steps),
            MixingConfig(**kw), PP_L, record_every=PP_RECORD, device="cpu")
    return engine.train_population_pipelined(
        0, pp_init, PP_STAGE_FNS, pp_data, pp_tcfg(n, optimizer, steps),
        MixingConfig(**kw), PP_L, record_every=PP_RECORD, mesh=mesh,
        microbatches=micro, device="cpu")


def pipeline(rank: int, world: int, data) -> dict:
    from repro_torch.core.consensus import avg_distance_to_consensus
    from repro_torch.core.population import gather_population
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint, engine

    out = {}
    meshes = {}
    for tag, kind, shape, n, micro, kw, optimizer, steps in PP_RUNS:
        if (kind, shape, n) not in meshes:  # every rank, in one order
            meshes[kind, shape, n] = make_host_mesh(
                n, kind, mesh_shape=shape, device="cpu")
        mesh = meshes[kind, shape, n]
        res = pp_train(kw, optimizer, n, steps, mesh, micro)
        traces = engine.chunk_trace_count()
        for k, v in flat_tree(res.population).items():
            if not k.startswith("blocks"):  # replicated over the stages
                out[f"{tag}/rep{rank}/{k}"] = v.numpy()
        out[f"{tag}/coords{rank}"] = np.asarray(
            [mesh.coords[a] for a in mesh.axis_names])
        full = gather_population(res.population, mesh,
                                 stage_split=res.stage_split)
        mu = (gather_population(res.opt_state["mu"], mesh,
                                stage_split=res.stage_split)
              if "mu" in res.opt_state else None)
        if rank == 0:
            out.update(flat_tree(full, f"{tag}/p/"))
            if mu is not None:
                out.update(flat_tree(mu, f"{tag}/mu/"))
            for k in ("loss", "consensus", "comm", "step"):
                out[f"{tag}/{k}"] = np.asarray(res.history[k])
            out[f"{tag}/traces"] = np.asarray(traces)
            out[f"{tag}/stacked_consensus"] = np.asarray(
                float(avg_distance_to_consensus(full)))
            if tag.startswith("washopt_2x2"):
                path = checkpoint.save(os.path.join(data["dir"].item(),
                                                    "pp_pop"), full)
                out.update(flat_tree(checkpoint.restore(path, full),
                                     f"{tag}/restored/"))

    # the train CLI on (2, 2), two microbatches
    train_cli.main(PP_CLI + ["--mesh", "ens_pp", "--pp-stages", "2",
                             "--microbatches", "2", "--ckpt-population",
                             os.path.join(data["dir"].item(), "pp_cli")])
    return out


SV_TINY = dict(name="tiny", d_model=32, d_ff=64, num_layers=4, num_heads=4,
               num_kv_heads=2, vocab_size=64, max_position=128,
               dtype="float32")
SV_CFGS = {"gqa": SV_TINY,
           "mla": dict(SV_TINY, name="tinymla", num_kv_heads=4, mla=True,
                       kv_lora_rank=8, qk_rope_dim=4, qk_nope_dim=4,
                       v_head_dim=8),
           "moe": dict(SV_TINY, name="tinymoe", moe=True,
                       n_routed_experts=4, top_k=2, capacity_factor=0.5)}
SV_PROMPT, SV_NEW, SV_SEED, SV_TEMP = 6, 5, 5, 0.8
# staged runs: (tag, config, stages, temperature)
SV_RUNS = [("pp4_gqa", "gqa", 4, 0.0), ("pp4_gqa_t", "gqa", 4, SV_TEMP),
           ("pp2_gqa", "gqa", 2, 0.0), ("pp2_gqa_t", "gqa", 2, SV_TEMP),
           ("pp4_mla", "mla", 4, 0.0), ("pp2_mla_t", "mla", 2, SV_TEMP)]
# data-mesh runs: (tag, config, batch, mode, temperature)
SV_DATA = [("d_b8_soup", "gqa", 8, "soup", 0.0),
           ("d_b8_soup_t", "gqa", 8, "soup", SV_TEMP),
           ("d_b8_ens", "gqa", 8, "ensemble", 0.0),
           ("d_b6_soup", "gqa", 6, "soup", 0.0),
           ("d_b6_ens_t", "gqa", 6, "ensemble", SV_TEMP),
           ("d_b8_moe", "moe", 8, "soup", 0.0)]
SV_CLI = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
          "--population", "2", "--batch-size", "4", "--seq-len", "8",
          "--max-new", "4"]


def sv_cli_cfg():
    """Reduced llama3.2-3b cut to 4 layers, so that 4 stages divide it."""
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("llama3.2-3b").reduced(),
                               num_layers=4)


def sv_model(name: str):
    """(cfg, a population of 2 from seeds 0 and 1) of ``SV_CFGS[name]``."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import population as pop
    from repro_torch.models import transformer as M

    cfg = ModelConfig(**SV_CFGS[name])
    return cfg, pop.stack([M.init_params(cfg, seed=s, device="cpu")
                           for s in range(2)])


def sv_tokens(batch: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(batch)
    return torch.randint(0, 64, (batch, SV_PROMPT), generator=g,
                         dtype=torch.int32)


def sv_generate(name, batch, mode, temp, mesh=None, seeds=None, rows=None):
    """The request of a run, at world 1 when ``mesh`` is None; ``rows``
    serves those rows of the batch alone (with ``seeds`` one a row)."""
    from repro_torch.serving import engine

    cfg, popn = sv_model(name)
    tokens = sv_tokens(batch)
    if rows is not None:
        tokens = tokens[rows]
    seed = seeds if seeds is not None else (SV_SEED if temp > 0 else None)
    return engine.generate(engine.serving_params(popn, mode), cfg,
                           {"tokens": tokens}, SV_NEW, temperature=temp,
                           seed=seed, mode=mode, device="cpu", mesh=mesh)


def serving(rank: int, world: int, data) -> dict:
    from repro_torch import obs
    from repro_torch.core import averaging
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import (make_host_data_mesh,
                                         make_host_ensemble_mesh,
                                         make_host_pipe_mesh)
    from repro_torch.serving import engine

    out = {}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[rank // 2]
    meshes = {4: make_host_pipe_mesh(4, "cpu"),
              2: make_host_pipe_mesh(2, "cpu", group=pair)}
    for tag, name, stages, temp in SV_RUNS:
        out[tag] = sv_generate(name, 4, "soup", temp, meshes[stages]).numpy()
    # one program pair serves two requests of one shape, each reported
    engine.reset_trace_counts()
    engine.clear_executable_cache()
    tel = obs.configure(memory=True)
    try:
        for _ in range(2):
            sv_generate("gqa", 4, "soup", 0.0, meshes[4])
        compiles = [tel.registry.counter(f"compile.{k}").value for k in (
            "serve_prefill_staged", "serve_decode_staged", "serve_prefill",
            "serve_decode")]
    finally:
        obs.reset()
    out["programs"] = np.asarray([engine.prefill_trace_count(),
                                  engine.decode_trace_count(),
                                  engine.executable_cache_size(), *compiles])

    dmesh = make_host_data_mesh("cpu")
    for tag, name, batch, mode, temp in SV_DATA:
        out[tag] = sv_generate(name, batch, mode, temp, dmesh).numpy()
        cfg = sv_model(name)[0]
        out[f"{tag}/layout"] = np.asarray(engine.data_layout(cfg, dmesh,
                                                             batch))

    # an ensemble-engine result: N = 4, two members on each rank of a pair
    res = toy_train(dict(kind="wash", base_p=0.5, mode="bucketed"),
                    make_host_ensemble_mesh(TOY_N, "cpu", group=pair))
    out.update(flat_tree(averaging.uniform_soup(res.population),
                         "block_soup/"))
    out.update(flat_tree(engine.serving_params(res, "soup"), "soup/"))
    out.update(flat_tree(engine.averaged_params(res), "averaged/"))
    out.update(flat_tree(engine.serving_params(res, "member", 3), "member3/"))
    out.update(flat_tree(engine.serving_params(res, "ensemble"), "ens/"))

    cfg = sv_cli_cfg()
    ckpt = data["ckpt"].item()
    for tag, extra in (("cli_pp4", ["--pp-stages", "4"]),
                       ("cli_pp4_ckpt", ["--pp-stages", "4", "--ckpt", ckpt]),
                       ("cli_data", ["--mesh", "data"])):
        outs = serve.main(SV_CLI + extra, cfg=cfg)
        out[tag] = outs["soup"]["tokens"].numpy()
    return out


def start(scenario: str, world: int, path: str, inputs: dict,
          timeout: float = 120.0):
    """Start SCENARIO on ``world`` ranks in fresh processes with
    ``inputs`` (numpy arrays); returns ``wait()``, which gives each rank's
    results.  The ranks share one deadline of ``timeout`` seconds from
    the start, past which all are killed and ``wait`` fails, so a ring
    that deadlocks fails rather than hangs."""
    np.savez(os.path.join(path, "in.npz"), **inputs)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout

    def wait() -> list:
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))[0])
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{scenario} on {world} ranks passed its "
                                 f"{timeout:.0f} s deadline")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        bad = [(r, p.returncode, log)
               for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
        assert not bad, "\n".join(f"rank {r} exited {rc}:\n{log[-3000:]}"
                                   for r, rc, log in bad)
        return [dict(np.load(os.path.join(path, f"out_{r}.npz")))
                for r in range(world)]

    return wait


def main() -> int:
    scenario, rank, world, path = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)  # the ranks share the host's cores
    store = dist.FileStore(os.path.join(path, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        data = np.load(os.path.join(path, "in.npz"))
        out = {"collective": collective, "engine": engine_runs,
               "multiaxis": multiaxis, "pipeline": pipeline,
               "serving": serving}[scenario](rank, world, data)
        np.savez(os.path.join(path, f"out_{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    sys.exit(main())
