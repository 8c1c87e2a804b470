"""The contract matrix: one :class:`~repro_torch.analysis.contracts.Contract`
per step program the port runs.

Port of ``repro/analysis/matrix.py``, over recorded events and storages
in place of HLO.  Five entries:

``train_chunk``
    The ensemble engine's chunk (``train.engine.make_fused_chunk_fn``)
    on an ens mesh of 2 ranks (rank pairs of a larger world; at world 1
    both members on the one rank): the WASH ring's sends and receives and
    the loss all-reduce, nothing else, all float32 on the wire; the
    population and optimizer state updated in place; at most two chunk
    functions built a run; the host comm exact builtin float64 that
    replays bit for bit.  At world 1 no collective at all.

``pipelined_train``
    The pipelined chunk (``make_pipelined_chunk_fn``) on an (ens=2,
    pipe=2) mesh of 4 ranks (at world 1: (1, 1), two microbatches): the
    same clauses, plus every point-to-point pair a stage-ring hop, a
    forward hop or a backward hop.  Global ranks are
    ``launch/mesh.py::make_host_mesh``'s row-major fill, ``e * S + p``,
    the reference's device order on that mesh.

``scan_decode``
    The serving engine's decode program (``serving.engine``): no
    collective, the KV cache (argument 2) updated in place, one program a
    prompt shape (the same count for a repeat), one more for a new shape.

``continuous_decode``
    The continuous-batching decode step (``serving.batching``): no
    collective, both paged pools updated in place, one program a pool
    geometry across a mixed stream, reused by a second server.

``speculative_decode``
    The speculative decode step (``serving.speculative``): no collective,
    all four pools (verify and draft k/v) updated in place, one program a
    (geometry, ``draft_k``); a new ``draft_k`` adds exactly one.

:func:`run_matrix` runs the chosen entries on ``device`` ("cuda" unless
the caller asks for the CPU; the two training entries on the gloo or
NCCL world the caller initialized, world 1 in-process otherwise).  On
the card it also reports each serving entry's **host syncs per decode
step** with their call sites, as a reading and not a clause
(:func:`count_syncs`).
"""

from __future__ import annotations

import collections
import contextlib
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import contracts
from repro_torch.analysis.contracts import (
    Contract, ContractViolation, backward_hop, check_compile_count,
    check_host_comm_f64, forward_hop, replay_comm, stage_ring,
)
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import population as pop
from repro_torch.core import shardplan
from repro_torch.core.collectives import KINDS
from repro_torch.core.device import resolve_device
from repro_torch.core.layer_index import infer_layer_ids, total_layers
from repro_torch.core.mixing import MixingConfig, mixing_due, static_mix_comm
from repro_torch.core.prng import generator
from repro_torch.sharding import rules as sharding_rules

ENTRIES = ("train_chunk", "pipelined_train", "scan_decode",
           "continuous_decode", "speculative_decode")

# ---------------------------------------------------------------------------
# shared toy model (mirrors the reference's: stacked-blocks leaves so one
# member splits over a pipe axis)
# ---------------------------------------------------------------------------

_L, _DIN, _D, _DOUT, _B, _N = 4, 16, 8, 4, 8, 2


def _toy_device(device) -> torch.device:
    """Where the training entries train the toy: ``device`` in-process,
    the CPU across gloo ranks."""
    world, _ = _world()
    return torch.device("cpu") if world > 1 else resolve_device(device)


def _toy_init(device):
    def init(seed: int):
        rng = np.random.default_rng(seed % (2 ** 63))
        w = lambda *s: torch.from_numpy(  # noqa: E731
            (rng.standard_normal(s) * 0.3).astype(np.float32)).to(device)
        return {"embed": {"w": w(_DIN, _D)},
                "blocks": {"w1": w(_L, _D, _D)},
                "head": {"w": w(_D, _DOUT)}}
    return init


def _toy_embed(p, b):
    return b["x"] @ p["embed"]["w"]


def _toy_blocks(p, x):
    for wl in p["blocks"]["w1"]:
        x = torch.tanh(x @ wl) + x
    return x


def _toy_head(p, x, b):
    return torch.mean((x @ p["head"]["w"] - b["y"]) ** 2)


def _toy_loss(p, b):
    return _toy_head(p, _toy_blocks(p, _toy_embed(p, b)), b)


def _toy_data(device):
    def data(m, step, seed):
        g = generator(seed, device)
        return {"x": torch.randn((_B, _DIN), generator=g, device=device),
                "y": torch.randn((_B, _DOUT), generator=g, device=device)}
    return data


def _toy_member():
    """One toy member's shapes, on meta."""
    return pop.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"),
                        _toy_init("cpu")(0))


def _toy_tcfg(total_steps: int = 6) -> TrainConfig:
    return TrainConfig(population=_N, optimizer="sgd", lr=0.05,
                       total_steps=total_steps, batch_size=_B, seq_len=1,
                       seed=0)


def _tiny_model_cfg(num_layers: int = 4) -> ModelConfig:
    """A float32 GQA model the kernels take on the card (head dim 32)."""
    return ModelConfig(name="tiny", d_model=128, d_ff=256,
                       num_layers=num_layers, num_heads=4, num_kv_heads=2,
                       vocab_size=64, max_position=128, dtype="float32")


# ---------------------------------------------------------------------------
# checked programs and host syncs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _checked(owner, name: str, contract: Contract,
             reports: List[contracts.CheckReport],
             buffers: Optional[Callable[[], Any]] = None,
             factory: bool = True,
             syncs: Optional[collections.Counter] = None,
             device: Optional[torch.device] = None):
    """Replace ``owner.name`` for the block: a factory (``factory``) whose
    every built program is checked against ``contract`` at each call, or
    a method that is.  ``buffers()`` names state the program updates that
    is not one of its arguments (a server's pools).  With ``syncs`` and
    ``device`` the card, each call's host syncs are added to ``syncs`` by
    call site."""
    real = getattr(owner, name)

    def check(fn):
        def checked(*args):
            with count_syncs(device if syncs is not None else None) as sites:
                rep = contracts.run_and_check(
                    fn, args, contract,
                    buffers=None if buffers is None else buffers())
            if sites is not None:
                syncs.update(sites)
            reports.append(rep)
            return rep.result
        return checked

    setattr(owner, name, (lambda *a, **k: check(real(*a, **k))) if factory
            else check(real))
    try:
        yield reports
    finally:
        if factory:
            setattr(owner, name, real)
        else:
            delattr(owner, name)  # the class's method again


def _site(stack) -> str:
    """The innermost frame of the port's own code in ``stack``."""
    ours = [f for f in stack if "repro_torch" in f.filename
            and "analysis" not in f.filename]
    if not ours:
        return "(outside repro_torch)"
    f = ours[-1]
    path = f.filename[f.filename.find("repro_torch"):]
    return f"{path}:{f.lineno} {f.name}"


@contextlib.contextmanager
def count_syncs(device: Optional[torch.device]):
    """Count the host syncs of the block on the card: each
    ``torch.cuda.set_sync_debug_mode("warn")`` warning, by the call site
    in the port that made it (the warning carries no stack: the stack is
    taken when it is shown).  Yields a ``Counter`` of ``site -> syncs``,
    or None off the card."""
    if device is None or device.type != "cuda":
        yield None
        return
    sites: collections.Counter = collections.Counter()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                sites[_site(traceback.extract_stack()[:-1])] += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def _sync_reading(sites, steps: int) -> Optional[Dict[str, Any]]:
    if sites is None or steps == 0:
        return None
    total = sum(sites.values())
    return {"per_decode_step": total / max(steps, 1), "decode_steps": steps,
            "sites": {k: v / max(steps, 1) for k, v in sites.most_common()}}


# ---------------------------------------------------------------------------
# the training entries
# ---------------------------------------------------------------------------


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _pair_group():
    """This rank's pair of ranks ([0, 1], [2, 3], ...) of an even world
    (every rank makes every pair's group), None at world 1 or 2."""
    world, rank = _world()
    if world <= 2:
        return None
    if world % 2:
        raise ValueError(f"train_chunk pairs ranks; the world is {world}")
    mine = None
    for a in range(0, world, 2):
        g = dist.new_group([a, a + 1])
        if a == rank - rank % 2:
            mine = g
    return mine


def _train_contract(name: str, world: int, **extra) -> Contract:
    if world == 1:
        return Contract(name=name, forbid_collectives=KINDS,
                        in_place_argnums=(0, 1))
    return Contract(name=name, require_collectives=("send", "recv",
                                                    "all_reduce"),
                    forbid_collectives=("all_gather", "broadcast"),
                    collective_dtypes={k: ("float32",) for k in KINDS},
                    in_place_argnums=(0, 1), **extra)


def _replay(name: str, cps: float, result, tcfg, mcfg) -> None:
    gates = [mixing_due(s, mcfg) for s in range(tcfg.total_steps)]
    replay = replay_comm(cps, gates)
    check_host_comm_f64({"comm_per_mix_step": cps,
                         "comm_scalars": result.comm_scalars,
                         "replay": replay}, name=f"{name}-host-comm")
    if replay != result.comm_scalars:
        raise ContractViolation(f"{name}-host-comm", [
            f"replayed comm {replay!r} != engine comm "
            f"{result.comm_scalars!r} (accumulation order or per-step value "
            f"drifted)"])


def check_train_chunk(device="cuda") -> Dict[str, Any]:
    """The ensemble engine's chunk on an ens mesh of 2 ranks (see the
    module): every chunk call checked, the chunk functions counted, the
    host comm replayed."""
    from repro_torch.launch.mesh import make_host_ensemble_mesh
    from repro_torch.train import engine as T

    dev = _toy_device(device)
    group = _pair_group()
    mesh = make_host_ensemble_mesh(_N, dev, group=group)
    world = mesh.world
    mcfg = MixingConfig(kind="wash", base_p=0.5, mode="bucketed")
    tcfg = _toy_tcfg()
    reports: List[contracts.CheckReport] = []
    T.reset_chunk_trace_count()
    with _checked(T, "make_fused_chunk_fn", _train_contract(
            "train_chunk", world), reports):
        result = T.train_population_sharded(
            0, _toy_init(dev), _toy_loss, _toy_data(dev), tcfg, mcfg, _L,
            record_every=3, mesh=mesh, device=dev)
    check_compile_count("train_chunk-compiles", T.chunk_trace_count(), (1, 2))
    member = _toy_member()
    lids = infer_layer_ids(member, _L)
    cps = static_mix_comm(member, mcfg, lids, total_layers(_L), _N,
                          opt_state=result.opt_state)
    _replay("train_chunk", cps, result, tcfg, mcfg)
    return {"reports": reports, "compiles": T.chunk_trace_count(),
            "comm_scalars": result.comm_scalars, "world": world}


def check_pipelined_train(device="cuda") -> Dict[str, Any]:
    """The pipelined chunk on an (ens, pipe) mesh: (2, 2) on 4 ranks,
    (1, 1) at world 1, two microbatches; every chunk call checked, pairs
    held to the stage ring and the one-stage hops."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import engine as T

    dev = _toy_device(device)
    world, _ = _world()
    if world not in (1, 4):
        raise ValueError(f"pipelined_train runs at world 1 or 4, not {world}")
    S = 2 if world == 4 else 1
    mesh = make_host_mesh(_N, "ens_pp", mesh_shape=(world // S, S),
                          device=dev)
    mcfg = MixingConfig(kind="wash", base_p=0.5, mode="bucketed")
    tcfg = _toy_tcfg()
    sf = T.StageFns(_toy_embed, _toy_blocks, _toy_head)
    contract = _train_contract(
        "pipelined_train", world,
        pair_rules=(stage_ring(S), forward_hop(S), backward_hop(S)))
    reports: List[contracts.CheckReport] = []
    T.reset_chunk_trace_count()
    with _checked(T, "make_pipelined_chunk_fn", contract, reports):
        result = T.train_population_pipelined(
            0, _toy_init(dev), sf, _toy_data(dev), tcfg, mcfg, _L,
            record_every=3, mesh=mesh, microbatches=2, device=dev)
    check_compile_count("pipelined_train-compiles", T.chunk_trace_count(),
                        (1, 2))
    member = _toy_member()
    lids = infer_layer_ids(member, _L)
    specs = sharding_rules.stage_member_specs(
        pop.tree_map(lambda _: sharding_rules.P(), member), lids, "pipe")
    pplan = shardplan.plan_population_mixing(mesh, member, specs, mcfg, lids,
                                             total_layers(_L), _N)
    cps = shardplan.static_shard_mix_comm(pplan, opt_state=result.opt_state)
    _replay("pipelined_train", cps, result, tcfg, mcfg)
    return {"reports": reports, "compiles": T.chunk_trace_count(),
            "comm_scalars": result.comm_scalars, "world": world}


# ---------------------------------------------------------------------------
# the serving entries
# ---------------------------------------------------------------------------

_SERVE = Contract(name="serve", forbid_collectives=KINDS)


def _tiny_params(cfg: ModelConfig, device):
    from repro_torch.models import transformer as M

    return M.init_params(cfg, seed=0, device=device)


def check_scan_decode(device="cuda") -> Dict[str, Any]:
    """The scan engine's decode program: no collective, the cache
    (argument 2) updated in place, one program a prompt shape."""
    from repro_torch.serving import engine as E

    device = resolve_device(device)
    cfg = _tiny_model_cfg()
    B, S, max_new = 2, 4, 8
    params = _tiny_params(cfg, device)
    contract = Contract(name="scan_decode", forbid_collectives=KINDS,
                        in_place_argnums=(2,))
    reports: List[contracts.CheckReport] = []
    E.reset_trace_counts()
    E.clear_executable_cache()
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32, device=device)}
    sites: collections.Counter = collections.Counter()
    with _checked(E, "_build_decode", contract, reports, syncs=sites,
                  device=device):
        E.generate(params, cfg, batch, max_new, device=device)
        E.generate(params, cfg, batch, max_new, device=device)
        check_compile_count("scan_decode-compiles-per-shape",
                            E.decode_trace_count(), 1)
        E.generate(params, cfg, {"tokens": torch.zeros(
            (B, S + 1), dtype=torch.int32, device=device)}, max_new,
            device=device)
        check_compile_count("scan_decode-compiles-new-shape",
                            E.decode_trace_count(), 2)
    return {"reports": reports, "compiles": E.decode_trace_count(),
            "syncs": _sync_reading(sites if device.type == "cuda" else None,
                                   len(reports) * (max_new - 1))}


def _stream(batching):
    return [batching.Request(uid=i, tokens=np.arange(1, 1 + s,
                                                     dtype=np.int32),
                             max_new=m)
            for i, (s, m) in enumerate([(5, 6), (9, 3), (3, 8), (7, 5)])]


def _paged_server(batching, params, cfg, device, **kw):
    return batching.ContinuousServer(
        params, cfg, temperature=0.0, page_size=4, max_slots=3,
        num_pages=32, device=device, **kw)


def _pool_buffers(server) -> Callable[[], Any]:
    return lambda: (server._pools, getattr(server, "_draft_pools", None))


def _serve_stream(batching, server, method: str, contract, reports, reqs,
                  device):
    """Run ``reqs`` through ``server`` with its decode step ``method``
    checked at every call; returns (the host syncs inside the decode
    steps by call site, on the card, else None; the decode steps)."""
    sites: collections.Counter = collections.Counter()
    with _checked(server, method, contract, reports,
                  buffers=_pool_buffers(server), factory=False,
                  syncs=sites, device=device):
        server.run(reqs)
    return (sites if device.type == "cuda" else None), len(reports)


def check_continuous_decode(device="cuda") -> Dict[str, Any]:
    """The continuous-batching decode step: no collective, both pools
    updated in place, one program a pool geometry, reused by a second
    server."""
    from repro_torch.serving import batching

    device = resolve_device(device)
    cfg = _tiny_model_cfg(2)
    params = _tiny_params(cfg, device)
    contract = Contract(name="continuous_decode", forbid_collectives=KINDS)
    reports: List[contracts.CheckReport] = []
    batching.reset_trace_counts()
    batching.clear_executable_cache()
    server = _paged_server(batching, params, cfg, device)
    sites, steps = _serve_stream(batching, server, "_decode_program",
                                 contract, reports, _stream(batching), device)
    check_compile_count("continuous_decode-compiles-per-geometry",
                        batching.decode_trace_count(), 1)
    server2 = _paged_server(batching, params, cfg, device)
    _serve_stream(batching, server2, "_decode_program", contract, reports,
                  [batching.Request(uid=90, tokens=np.array(
                      [1, 2, 3], np.int32), max_new=4)], device)
    check_compile_count("continuous_decode-compiles-reuse",
                        batching.decode_trace_count(), 1)
    return {"reports": reports, "compiles": batching.decode_trace_count(),
            "syncs": _sync_reading(sites, steps)}


def check_speculative_decode(device="cuda") -> Dict[str, Any]:
    """The speculative decode step: no collective, all four pools updated
    in place, one program a (geometry, draft_k), one more for a new
    draft_k."""
    from repro_torch.serving import batching

    device = resolve_device(device)
    cfg = _tiny_model_cfg(2)
    params = _tiny_params(cfg, device)
    draft_k = 3
    contract = Contract(name="speculative_decode", forbid_collectives=KINDS)
    reports: List[contracts.CheckReport] = []
    batching.reset_trace_counts()
    batching.clear_executable_cache()
    server = _paged_server(batching, params, cfg, device, speculative=True,
                           draft_k=draft_k)
    sites, steps = _serve_stream(batching, server, "_spec_program", contract,
                                 reports, _stream(batching), device)
    check_compile_count("speculative_decode-compiles-per-geometry",
                        batching.decode_trace_count(), 1)
    one = [batching.Request(uid=90, tokens=np.array([1, 2, 3], np.int32),
                            max_new=4)]
    for k, want in ((draft_k, 1), (draft_k + 2, 2)):
        again = _paged_server(batching, params, cfg, device,
                              speculative=True, draft_k=k)
        _serve_stream(batching, again, "_spec_program", contract, reports,
                      one, device)
        check_compile_count(
            "speculative_decode-compiles-"
            + ("reuse" if want == 1 else "new-draft-k"),
            batching.decode_trace_count(), want)
    return {"reports": reports, "compiles": batching.decode_trace_count(),
            "syncs": _sync_reading(sites, steps)}


def request_syncs(params, cfg: ModelConfig, batch, max_new: int,
                  device="cuda", mode: str = "soup") -> Optional[Dict]:
    """The host syncs per decode step of one scan-engine request
    (``serving.engine.generate``), by call site: the request runs once to
    build its program, then once counted inside its decode program (the
    ``max_new - 1`` decode steps).  None off the card."""
    from repro_torch.serving import engine as E

    device = resolve_device(device)
    counted: List[Any] = []
    real = E._build_decode

    def build(*a, **k):
        program = real(*a, **k)

        def watched(*args):
            with count_syncs(device) as sites:
                out = program(*args)
            counted.append(sites)
            return out
        return watched

    E.clear_executable_cache()
    E._build_decode = build
    try:
        for _ in range(2):
            E.generate(params, cfg, batch, max_new, mode=mode, device=device)
    finally:
        E._build_decode = real
        E.clear_executable_cache()
    return _sync_reading(counted[-1], max_new - 1)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

_CHECKS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "train_chunk": check_train_chunk,
    "pipelined_train": check_pipelined_train,
    "scan_decode": check_scan_decode,
    "continuous_decode": check_continuous_decode,
    "speculative_decode": check_speculative_decode,
}


def run_matrix(entries: Optional[Tuple[str, ...]] = None,
               device="cuda",
               raise_on_violation: bool = True) -> Dict[str, Any]:
    """Run the contract matrix on ``device`` (the training entries on the
    toy model on the CPU ranks of the caller's world, or in-process).
    Returns ``{entry: result}``; on any :class:`ContractViolation` raises
    one aggregate violation naming every failed entry (or records
    ``{"error": ...}`` per entry when ``raise_on_violation=False``)."""
    names = entries or ENTRIES
    unknown = set(names) - set(_CHECKS)
    if unknown:
        raise ValueError(f"unknown matrix entries {sorted(unknown)}; "
                         f"known: {list(ENTRIES)}")
    device = resolve_device(device)
    results: Dict[str, Any] = {}
    failures: List[str] = []
    for name in names:
        try:
            results[name] = _CHECKS[name](device)
        except ContractViolation as e:
            results[name] = {"error": str(e)}
            failures.append(f"{name}: {e}")
    if failures and raise_on_violation:
        raise ContractViolation("matrix", failures)
    return results
