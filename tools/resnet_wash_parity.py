#!/usr/bin/env python
"""Does the ResNet learn more slowly under WASH because of WASH, or
because of the port?  Both packages train the image experiment's ResNet
(``chip_smoke.py`` phase 10: depth 4, 32 x 32 images, N = 3 members,
heterogeneous augmentation policies, SGD at lr 0.05, dense WASH at
p = 0.05 against the baseline with no mixing) at a reduced width on the
CPU, from the same data: JAX's initial population, JAX's batches with
JAX's augmentation draws, and JAX's WASH plans, crossed into the port as
arrays.  Every ``--every`` steps both evaluate the ensemble, the uniform
soup and the best member on one eval set, and the curves are compared
step by step.

    PYTHONPATH=src python tools/resnet_wash_parity.py
    PYTHONPATH=src python tools/resnet_wash_parity.py --width 8 \
        --steps 300 --batch 32 --out build/resnet_parity.json

It prints one line per record step and run (WASH, baseline), the two
packages side by side, then a verdict: the first record step where the
packages part (their ensemble accuracies differ by more than ``--tol``)
or none, and each package's WASH-minus-baseline gap at the end.  Float32
arithmetic in another order makes the trajectories drift apart slowly in
any case, so the largest parameter difference at each record step is
printed too.  JAX runs on the CPU; nothing here needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import averaging as javg  # noqa: E402
from repro.core import mixing as jmix  # noqa: E402
from repro.core import shuffle as jshf  # noqa: E402
from repro.core.layer_index import infer_layer_ids, total_layers  # noqa: E402
from repro.core.population import init_population  # noqa: E402
from repro.core.prng import step_key  # noqa: E402
from repro.data import augment as JAUG  # noqa: E402
from repro.data import synthetic as JSYN  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import averaging as tavg  # noqa: E402
from repro_torch.core import mixing as tmix  # noqa: E402
from repro_torch.core import population as pop  # noqa: E402
from repro_torch.core import shuffle as tshf  # noqa: E402
from repro_torch.data import soft_cross_entropy  # noqa: E402
from repro_torch.models import cnn as TC  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train.interop import params_from_numpy  # noqa: E402

N, LR, P, NOISE, DEPTH, HW = 3, 0.05, 0.05, 0.35, 4, 32


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=8,
                   help="the first stage's channels (phase 10: 64)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=32,
                   help="images a member a step (phase 10: 128)")
    p.add_argument("--every", type=int, default=25,
                   help="evaluate every this many steps")
    p.add_argument("--eval", type=int, default=512, help="eval images")
    p.add_argument("--tol", type=float, default=0.05,
                   help="ensemble accuracies further apart than this part")
    p.add_argument("--seed", type=int, default=19)
    p.add_argument("--out", default=None, help="write the curves as JSON")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    kw = dict(kind="resnet", width=args.width, depth=DEPTH, image_hw=HW,
              num_classes=10)
    jcfg, tcfg = JC.ClassifierConfig(**kw), TC.ClassifierConfig(**kw)
    key = jax.random.key(args.seed)
    task = JSYN.make_image_task(jax.random.fold_in(key, 1), 10, HW,
                                noise=NOISE)
    pols = JAUG.member_policies(jax.random.fold_in(key, 7), N, True)
    ex, ey = JSYN.eval_images(task, jax.random.fold_in(key, 99), args.eval)
    tex, tey = torch.from_numpy(np.array(ex)), torch.from_numpy(np.array(ey))

    def jax_batch(m: int, s: int):
        k = jax.random.fold_in(jax.random.fold_in(key, 1000 + s), m)
        x, y = JSYN.sample_images(task, k, args.batch)
        x, y = JAUG.apply_policy(jax.random.fold_in(k, 1), x, y, 10, pols[m])
        return np.array(x), np.array(y)

    cache = {}

    def batch(m, s):
        if (m, s) not in cache:
            cache.clear() if len(cache) > 4 * N else None
            cache[m, s] = jax_batch(m, s)
        return cache[m, s]

    def jinit(k):
        return JC.init_classifier(k, jcfg)

    def jloss(p, b):
        return JAUG.soft_cross_entropy(JC.apply_classifier(p, jcfg, b["x"]),
                                       b["y"])

    def japply(p, x):
        return JC.apply_classifier(p, jcfg, x)

    def tapply(p, x):
        return TC.apply_classifier(p, tcfg, x)

    params = {"jax": [], "torch": []}  # each record step's leaves

    def jrecord(step, population):
        params["jax"].append([np.array(x) for x in
                              jax.tree_util.tree_leaves(population)])
        return {"ensemble": float(javg.ensemble_accuracy(
            japply, population, ex, ey)),
            "soup": float(javg.model_accuracy(
                japply, javg.uniform_soup(population), ex, ey)),
            "best": float(jnp.max(javg.member_accuracies(
                japply, population, ex, ey)))}

    def trecord(step, population):
        params["torch"].append([x.numpy().copy() for x in
                                pop.tree_leaves(population)])
        with torch.no_grad():
            return {"ensemble": float(tavg.ensemble_accuracy(
                tapply, population, tex, tey)),
                "soup": float(tavg.model_accuracy(
                    tapply, tavg.uniform_soup(population), tex, tey)),
                "best": float(tavg.member_accuracies(
                    tapply, population, tex, tey).max())}

    jpop = init_population(jinit, jax.random.key(0), N)
    lids = infer_layer_ids(jax.tree_util.tree_map(lambda x: x[0], jpop),
                           jcfg.num_blocks)
    base = jax.random.fold_in(jax.random.key(0), 1234)
    # the plans JAX's loop draws, step by step (its base key and step keys)
    draw = jax.jit(lambda k: jshf.make_plan(
        k, jpop, lids, total_layers(jcfg.num_blocks), P, "decreasing",
        "dense"))
    # every member starts at JAX's theta_0 (same_init, as phase 10)
    init = params_from_numpy(jax.tree_util.tree_map(
        np.array, jinit(jax.random.key(0))), "cpu")
    runs = {}
    for name, kind in (("WASH", "wash"), ("baseline", "none")):
        mkw = dict(kind=kind, base_p=P, mode="dense")
        t0 = time.time()
        jres = jloop.train_population(
            jax.random.key(0), jinit, jloss,
            lambda m, s, k: dict(zip(("x", "y"), map(jnp.asarray,
                                                     batch(m, s)))),
            JTrainConfig(population=N, optimizer="sgd", lr=LR,
                         total_steps=args.steps, batch_size=args.batch),
            jmix.MixingConfig(**mkw), jcfg.num_blocks,
            record_every=args.every, record_fn=jrecord)
        tj = time.time() - t0

        def jax_plan(seed, params, *a, _step=[0], **k):
            plan = draw(step_key(base, _step[0]))
            _step[0] += 1
            return pop.tree_map(
                lambda x: None if x is None else torch.from_numpy(x),
                jax.tree_util.tree_map(np.array, plan))

        real = tshf.make_plan
        tshf.make_plan = jax_plan
        t0 = time.time()
        try:
            tres = tloop.train_population(
                0, lambda s: pop.tree_map(torch.clone, init),
                lambda p, b: soft_cross_entropy(tapply(p, b["x"]), b["y"]),
                lambda m, s, seed: dict(zip(("x", "y"), map(
                    torch.from_numpy, batch(m, s)))),
                TrainConfig(population=N, optimizer="sgd", lr=LR,
                            total_steps=args.steps, batch_size=args.batch),
                tmix.MixingConfig(**mkw), tcfg.num_blocks,
                record_every=args.every, record_fn=trecord, device="cpu")
        finally:
            tshf.make_plan = real
        tt = time.time() - t0
        rows = []
        jh, th = jres.history, tres.history
        for i, step in enumerate(jh["step"]):
            diff = max(float(np.max(np.abs(a - b))) for a, b in zip(
                params["jax"][i], params["torch"][i]))
            rows.append({"step": step, "jax": {k: jh[k][i] for k in
                                               ("ensemble", "soup", "best")},
                         "torch": {k: th[k][i] for k in
                                   ("ensemble", "soup", "best")},
                         "loss": [jh["loss"][i], th["loss"][i]],
                         "max_param_diff": diff})
        runs[name] = rows
        params["jax"].clear()
        params["torch"].clear()
        print(f"{name}: JAX {tj:.1f} s, port {tt:.1f} s")
        for r in rows:
            print(f"  step {r['step']:4d}: ensemble JAX {r['jax']['ensemble']:.4f}"
                  f" port {r['torch']['ensemble']:.4f}; soup "
                  f"{r['jax']['soup']:.4f} / {r['torch']['soup']:.4f}; best "
                  f"member {r['jax']['best']:.4f} / {r['torch']['best']:.4f};"
                  f" loss {r['loss'][0]:.4f} / {r['loss'][1]:.4f}; max "
                  f"|param diff| {r['max_param_diff']:.3g}", flush=True)
    verdict = {}
    for name, rows in runs.items():
        parted = [r["step"] for r in rows if abs(
            r["jax"]["ensemble"] - r["torch"]["ensemble"]) > args.tol]
        verdict[name] = parted[0] if parted else None
    gap = {pkg: runs["WASH"][-1][pkg]["ensemble"]
           - runs["baseline"][-1][pkg]["ensemble"] for pkg in ("jax",
                                                                "torch")}
    print(f"verdict: first record step where the packages part by more "
          f"than {args.tol}: WASH {verdict['WASH']}, baseline "
          f"{verdict['baseline']}; WASH - baseline ensemble at step "
          f"{args.steps - 1}: JAX {gap['jax']:+.4f}, port "
          f"{gap['torch']:+.4f}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "runs": runs, "parted": verdict,
                       "gap": gap}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
