"""Quickstart: train a WASH population of classifiers, average, evaluate.

Port of ``examples/quickstart.py``, with its configuration and its table.
Shows the paper's central result end to end: a population trained with
parameter shuffling can be *weight averaged* into one model whose
accuracy matches the ensemble, while independently trained members
cannot.  On the card every shuffle runs the dense WASH kernel
(``kernels/wash_shuffle``).

  python -m repro_torch.launch.quickstart
  python -m repro_torch.launch.quickstart --device cpu
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import TrainConfig
from repro_torch.core import averaging as avg
from repro_torch.core.device import resolve_device
from repro_torch.core.mixing import MixingConfig
from repro_torch.core.prng import fold_in
from repro_torch.data import (apply_policy, eval_images, make_image_task,
                              member_policies, sample_images,
                              soft_cross_entropy)
from repro_torch.models.cnn import (ClassifierConfig, apply_classifier,
                                    init_classifier)
from repro_torch.train.loop import train_population


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Trains the two populations and prints the table; returns its rows
    (``method``, ``ensemble``, ``averaged``, ``comm``), each with the
    population's final ``consensus`` distance."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    seed = 0
    n_members = 4

    # a CIFAR-stand-in task (no dataset is downloaded)
    task = make_image_task(seed, num_classes=10, hw=12, noise=1.6,
                           device=device)
    ccfg = ClassifierConfig(kind="mlp", width=64, depth=3, num_classes=10,
                            image_hw=12)

    # heterogeneous members: each draws its own augmentation policy (paper §4)
    policies = member_policies(fold_in(seed, 7), n_members, True)

    def data_fn(member, step, s):
        images, labels = sample_images(task, s, 48)
        x, y = apply_policy(fold_in(s, 1), images, labels, 10,
                            policies[member])
        return {"x": x, "y": y}

    def loss_fn(params, batch):
        return soft_cross_entropy(apply_classifier(params, ccfg, batch["x"]),
                                  batch["y"])

    tcfg = TrainConfig(population=n_members, optimizer="sgd", lr=0.15,
                       total_steps=400, batch_size=48)

    print("training two populations (baseline vs WASH)...")
    results = {}
    for name, mcfg in (
        ("baseline", MixingConfig(kind="none")),
        ("wash", MixingConfig(kind="wash", base_p=0.05, mode="dense")),
    ):
        results[name] = train_population(
            seed, lambda s: init_classifier(s, ccfg, device), loss_fn,
            data_fn, tcfg, mcfg, ccfg.num_blocks, device=device)

    ex, ey = eval_images(task, fold_in(seed, 99), 512)

    def apply_fn(p, x):
        return apply_classifier(p, ccfg, x)

    rows = []
    print(f"\n{'method':10s} {'Ensemble':>9s} {'Averaged':>9s} "
          f"{'comm/member':>12s}")
    for name, res in results.items():
        ens = float(avg.ensemble_accuracy(apply_fn, res.population, ex, ey))
        soup = float(avg.model_accuracy(apply_fn,
                                        avg.uniform_soup(res.population),
                                        ex, ey))
        print(f"{name:10s} {ens:9.3f} {soup:9.3f} {res.comm_scalars:12.3e}")
        rows.append({"method": name, "ensemble": ens, "averaged": soup,
                     "comm": res.comm_scalars,
                     "consensus": res.history["consensus"][-1]})
    print("\nWASH: the averaged model keeps the ensemble's accuracy; the "
          "baseline's collapses.")
    return rows


if __name__ == "__main__":
    main()
