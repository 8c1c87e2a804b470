"""Time the dense WASH shuffle and the selective-scan forward of one tree
of the port on the card, at the shapes their main paths give them.

Run it once per tree to compare two trees on one card, in turns (parent,
change, change, parent), each from the repository root of the tree it
times, or with ``--src`` naming that tree's ``src``::

    python tools/redesign_timing.py --src /path/to/parent/src --tag parent
    python tools/redesign_timing.py --tag change

It imports nothing of JAX.  Each tree builds its own kernels at first use
(into its own ``build/``).  Device times per call are CUDA-graph replays
(no host launch overhead), mean over the replays; it prints one JSON line
with the card's name and power limit.  The calls are those both trees
have: ``wash_shuffle_cuda`` (out of place, one leaf), the stacked apply
``core.shuffle.apply_plan_stacked`` of a full-width ResNet's dense plan
(the training path's call, whatever it launches), and
``selective_scan_cuda`` (prefill from a carried state, a decode step over
32 layers' calls, the training shape from zero).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def device_ms(torch, fn, n_sets: int, reps: int = 20) -> float:
    """Device time of one ``fn(i)`` call: the calls over ``n_sets`` input
    sets captured in one CUDA graph, replayed ``reps`` times."""
    for i in range(n_sets):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_sets):
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
    return start.elapsed_time(end) / (reps * n_sets)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def dense_times(torch, device) -> dict:
    import numpy as np

    from repro_torch.core import layer_index as li
    from repro_torch.core import population as pop
    from repro_torch.core import schedules as sch
    from repro_torch.core import shuffle as shf
    from repro_torch.kernels import wash_shuffle as ws
    from repro_torch.models.cnn import ClassifierConfig, init_classifier

    out = {}
    # blocks.mlp.w1 of llama3.2-3b at 4 layers, N = 2, f32, p = 0.01
    layers, rest = 4, 3072 * 8192
    gen = torch.Generator(device=device)
    gen.manual_seed(60)
    x = torch.randn(2, layers * rest, generator=gen, device=device)
    p_vec = sch.layer_probability_array(0.01, np.arange(1, layers + 1),
                                        layers + 2, "decreasing")
    perm, mask = shf.dense_plan_layered(61, (layers, rest), 2, p_vec, device)
    perm, mask = perm.reshape(2, -1), mask.reshape(-1)
    out["w1_out_of_place_ms"] = device_ms(
        torch, lambda _: ws.wash_shuffle_cuda(x, perm, mask), 1)
    del x, perm, mask
    torch.cuda.empty_cache()
    # the ResNet's stacked apply: full width, N = 3, f32, p = 0.05
    cfg = ClassifierConfig(kind="resnet", width=64, depth=4, image_hw=32,
                           num_classes=10)
    member = init_classifier(0, cfg, device)
    params = pop.tree_map(lambda t: torch.randn(
        (3,) + tuple(t.shape), generator=gen, device=device), member)
    plan = shf.make_plan(5, params, li.infer_layer_ids(member, cfg.num_blocks),
                         li.total_layers(cfg.num_blocks), 0.05, "decreasing",
                         "dense")
    leaves = sum(p is not None for p in pop.tree_leaves(
        plan, is_leaf=lambda p: p is None or isinstance(p, tuple)))
    out["resnet_apply_ms"] = device_ms(
        torch, lambda _: shf.apply_plan_stacked(plan, params, "dense"), 1)
    out["resnet_planned_leaves"] = leaves
    return out


def ssm_times(torch, device) -> dict:
    from repro_torch.kernels import selective_scan as ssk

    def inputs(B, T, DI, seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=device)

        dt = torch.nn.functional.softplus(randn(B, T, DI) - 2)
        A = -torch.exp(torch.log(torch.arange(1, 17, dtype=torch.float32,
                                              device=device))
                       + 0.1 * randn(DI, 16))
        return (randn(B, T, DI), dt, randn(B, T, 16), randn(B, T, 16), A,
                randn(B, DI, 16))

    def timed(B, T, n_sets, carried, seed):
        sets = [inputs(B, T, 3200, seed + i) for i in range(n_sets)]
        return device_ms(torch, lambda i: ssk.selective_scan_cuda(
            *sets[i][:5], state=sets[i][5] if carried else None), n_sets)

    return {"prefill_ms": timed(4, 2048, 2, True, 170),
            "decode_step_ms": timed(4, 1, 32, True, 180),
            "train_ms": timed(2, 256, 2, False, 176)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"),
                    help="the src directory of the tree to time")
    ap.add_argument("--tag", default="", help="a name for the JSON line")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("redesign_timing: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    res = {"tag": args.tag, "src": args.src, "card": card()}
    res.update(dense_times(torch, device))
    res.update(ssm_times(torch, device))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
