"""Run the port's analysis lane: the lints, then the contract matrix.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --skip-contracts
    PYTHONPATH=src python -m repro_torch.analysis --entries scan_decode

* **Lints** (:mod:`repro_torch.analysis.lint`, stdlib only): host-sync,
  f32-accumulator and thread-discipline over ``src/repro_torch``, with
  the checked baseline ``analysis/baseline.txt`` (every waiver needs a
  justification; a stale waiver is itself an error).
* **Contracts** (:mod:`repro_torch.analysis.matrix`): the five step
  programs run and held to their contracts on ``--device`` (the card
  unless the caller asks for the CPU); on the card each serving entry
  also prints its host syncs per decode step with their call sites.

Exits non-zero on any lint violation, stale waiver or contract
violation.  Under ``torchrun`` (or any initialized group of 4 ranks) the
training entries run across the ranks.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import lint

ROOT = Path(__file__).resolve().parents[3]
BASELINE = Path(__file__).resolve().parent / "baseline.txt"

# repro_torch.analysis.matrix.ENTRIES without importing torch to build
# the parser; the test of the runner holds them equal
MATRIX_ENTRIES = ("train_chunk", "pipelined_train", "scan_decode",
                  "continuous_decode", "speculative_decode")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's lints and contract matrix.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--root", default=str(ROOT),
                   help="repository root whose src/repro_torch is linted")
    p.add_argument("--baseline", default=str(BASELINE),
                   help="checked suppression baseline")
    p.add_argument("--rules", nargs="+", choices=lint.RULES, default=None,
                   help="restrict the lints to these rules")
    p.add_argument("--entries", nargs="+", choices=MATRIX_ENTRIES,
                   default=None, help="restrict the matrix to these entries")
    p.add_argument("--skip-lint", action="store_true", help="skip the lints")
    p.add_argument("--skip-contracts", action="store_true",
                   help="skip the contract matrix")
    p.add_argument("--device", default="cuda",
                   help="where the matrix runs: cuda, or cpu")
    return p


def run_lints(root, baseline_path, rules=None) -> int:
    violations = lint.lint_tree(Path(root))
    if rules:
        violations = [v for v in violations if v.rule in rules]
    try:
        baseline = lint.load_baseline(baseline_path)
    except (OSError, ValueError) as e:
        print(f"analysis: bad baseline: {e}", file=sys.stderr)
        return 1
    violations, stale = lint.apply_baseline(violations, baseline)
    if rules:
        stale = [k for k in stale if k.split(":", 1)[0] in rules]
    for v in violations:
        print(f"{v.path}:{v.line}: [{v.rule}] {v.message}", file=sys.stderr)
    for k in stale:
        print(f"stale baseline entry (matches nothing, remove it): {k}",
              file=sys.stderr)
    if violations or stale:
        print(f"analysis: lint FAILED ({len(violations)} violation(s), "
              f"{len(stale)} stale waiver(s))", file=sys.stderr)
        return 1
    print(f"analysis: lint OK (rules: {', '.join(rules or lint.RULES)}; "
          f"{len(baseline)} waivers)")
    return 0


def run_contracts(entries, device) -> int:
    from repro_torch.analysis import contracts, matrix

    assert matrix.ENTRIES == MATRIX_ENTRIES, \
        "MATRIX_ENTRIES must match repro_torch.analysis.matrix.ENTRIES"
    try:
        results = matrix.run_matrix(tuple(entries) if entries else None,
                                    device=device)
    except contracts.ContractViolation as e:
        print(f"analysis: contract matrix FAILED\n{e}", file=sys.stderr)
        return 1
    for name, r in results.items():
        print(f"analysis: contract {name} OK (compiles={r['compiles']}, "
              f"checked calls={len(r['reports'])})")
        syncs = r.get("syncs")
        if syncs is not None:
            sites = "; ".join(f"{k}: {v:g}" for k, v in
                              syncs["sites"].items()) or "none"
            print(f"analysis: {name} host syncs per decode step "
                  f"{syncs['per_decode_step']:g} ({syncs['decode_steps']} "
                  f"steps): {sites}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rc = 0
    if not args.skip_lint:
        rc |= run_lints(args.root, args.baseline, args.rules)
    if not args.skip_contracts:
        rc |= run_contracts(args.entries, args.device)
    if rc == 0:
        print("analysis: OK")
    return rc


if __name__ == "__main__":
    sys.exit(main())
