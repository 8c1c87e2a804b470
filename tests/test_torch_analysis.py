"""The port's analysis lane (``repro_torch.analysis``) and its collective
recorder (``repro_torch.core.collectives``).

* the contract vocabulary against the JAX package's
  (``repro.analysis.contracts``): pair-rule verdicts, comm replay, the
  host-f64 and compile-count checks on the same inputs;
* every contract clause catching a seeded violation (a forbidden
  collective, a wrong count or dtype, a pair outside the rules, a
  reallocated buffer, one program too many);
* the matrix at world 1 in-process (through the runner) and its two
  training entries on 4 gloo ranks (one spawn of
  ``tests/torch_ring_worker.py``'s ``analysis`` scenario);
* the lints: the reference's violation keys on ``tests/analysis_fixtures``
  for the two rules carried over, the host-sync fixture pair, the port
  clean modulo its baseline, a stale waiver failing;
* the recorder: every collective of the port goes through it, and its
  dry mode records without issuing.
"""

import ast
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import contracts as jc
from repro.analysis import lint as jlint
from repro_torch.analysis import __main__ as runner
from repro_torch.analysis import contracts as tc
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import matrix
from repro_torch.core import collectives as coll

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures"
TORCH_FIXTURES = REPO / "tests" / "analysis_torch_fixtures"
sys.path.insert(0, str(REPO / "tests"))

import torch_ring_worker as W  # noqa: E402


# ---------------------------------------------------------------------------
# the contract vocabulary against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["stage_ring", "forward_hop",
                                  "backward_hop"])
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_pair_rule_verdicts_equal_the_reference(kind, stages):
    ours, theirs = tc.PairRule(kind, stages), jc.PairRule(kind, stages)
    for src in range(12):
        for tgt in range(12):
            assert ours.ok(src, tgt) == theirs.ok(src, tgt), (src, tgt)
    assert ours.describe() == theirs.describe()


def test_replay_and_host_checks_equal_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(5):
        per = float(rng.integers(1, 10 ** 9)) / 7.0
        gates = [bool(g) for g in rng.integers(0, 2, 23)]
        assert tc.replay_comm(per, gates) == jc.replay_comm(per, gates)
    for values in ({"a": 1.5, "b": 2.0}, {"a": np.float64(1.0)},
                   {"a": float("nan")}, {"a": 3}, {"a": torch.tensor(1.0)}):
        got = [None, None]
        for i, mod in enumerate((tc, jc)):
            try:
                mod.check_host_comm_f64(values)
            except AssertionError as e:
                got[i] = e.problems
        assert got[0] == got[1], values
    for count, expect in ((1, 1), (2, 1), (2, (1, 2)), (3, (1, 2)),
                          (0, (1, 2))):
        raised = []
        for mod in (tc, jc):
            try:
                mod.check_compile_count("c", count, expect)
                raised.append(None)
            except AssertionError as e:
                raised.append(e.problems)
        assert raised[0] == raised[1], (count, expect)


# ---------------------------------------------------------------------------
# seeded violations: each clause fails
# ---------------------------------------------------------------------------


def _ev(kind, dtype="float32", pair=None, nbytes=16):
    return coll.Event(kind, (0, 1), pair, dtype, nbytes)


RING = [_ev("send", pair=(0, 2)), _ev("recv", pair=(2, 0)),
        _ev("all_reduce")]


def test_clean_events_pass():
    c = tc.Contract("ok", require_collectives=("send", "all_reduce"),
                    forbid_collectives=("all_gather",),
                    counts={"send": 1, "all_reduce": (1, 2)},
                    pair_rules=(tc.stage_ring(2),),
                    collective_dtypes={"send": ("float32",)})
    rep = tc.check_events(RING, c)
    assert rep.ok and rep.pairs == [(0, 2), (2, 0)]


@pytest.mark.parametrize("contract, events, fragment", [
    (tc.Contract("forbid", forbid_collectives=("all_gather",)),
     RING + [_ev("all_gather")], "forbidden collective 'all_gather'"),
    (tc.Contract("require", require_collectives=("broadcast",)), RING,
     "required collective 'broadcast' absent"),
    (tc.Contract("count", counts={"all_reduce": 2}), RING,
     "all_reduce: 1 ops, expected 2"),
    (tc.Contract("range", counts={"send": (2, 3)}), RING,
     "send: 1 ops outside [2, 3]"),
    (tc.Contract("dtype", collective_dtypes={"all_reduce": ("float32",)}),
     RING + [_ev("all_reduce", dtype="bfloat16")],
     "all_reduce moves dtypes ['bfloat16']"),
    (tc.Contract("pairs", pair_rules=(tc.stage_ring(2),
                                      tc.forward_hop(2))),
     RING + [_ev("send", pair=(1, 2))], "pair (1 -> 2) violates"),
    (tc.Contract("no-pairs", pair_rules=(tc.stage_ring(2),)),
     [_ev("all_reduce")], "no point-to-point op ran"),
])
def test_each_clause_catches_its_seeded_violation(contract, events,
                                                  fragment):
    with pytest.raises(tc.ContractViolation) as e:
        tc.check_events(events, contract)
    assert any(fragment in p for p in e.value.problems), e.value.problems


def test_in_place_clause_catches_a_reallocated_buffer():
    c = tc.Contract("in-place", in_place_argnums=(0,))
    state = {"k": torch.zeros(4), "v": torch.zeros(4)}

    def in_place(s):
        s["k"].add_(1.0)
        return s

    rep = tc.run_and_check(in_place, (state,), c)
    assert rep.ok and rep.result is state

    def reallocates(s):
        s["v"] = s["v"] + 1.0  # a new storage behind the same key
        return s

    with pytest.raises(tc.ContractViolation, match="leaf 1 reallocated"):
        tc.run_and_check(reallocates, (state,), c)
    pools = [{"k": torch.zeros(3)}]

    def drops(s):
        pools[0] = {}
        return s

    with pytest.raises(tc.ContractViolation, match="3 tensor leaves before"):
        tc.run_and_check(drops, (state,), c, buffers=pools)


def test_compile_clause_catches_one_program_too_many():
    with pytest.raises(tc.ContractViolation, match="compiled 3"):
        tc.check_compile_count("train", 3, (1, 2))


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

_COLLECTIVES = {"all_reduce", "all_gather", "broadcast", "send", "recv",
                "isend", "irecv", "batch_isend_irecv", "P2POp",
                "reduce_scatter", "all_to_all", "all_gather_into_tensor",
                "reduce_scatter_tensor", "gather", "scatter", "reduce",
                "all_gather_object", "barrier"}


def test_every_collective_of_the_port_goes_through_the_recorder():
    offenders = []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        if path.name == "collectives.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "dist"
                    and node.attr in _COLLECTIVES):
                offenders.append(f"{path.relative_to(REPO)}:{node.lineno} "
                                 f"dist.{node.attr}")
    assert not offenders, offenders


def test_dry_recording_logs_and_issues_nothing():
    g = coll.DryGroup((0, 4, 8, 12))
    x = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
    assert coll._events is None
    with coll.record(dry_rank=4) as ev:
        coll.all_reduce(x, group=g)
        parts = [torch.empty_like(x) for _ in range(4)]
        coll.all_gather(parts, x, group=g)
        coll.exchange([("send", x, 8), ("recv", x, 0)], g)
        coll.broadcast(x, src=0, group=g)
        with coll.record(dry_rank=4) as inner:
            coll.send(x, 12, group=g)
    assert coll._events is None and len(inner) == 1
    assert [e.kind for e in ev] == ["all_reduce", "all_gather", "send",
                                    "recv", "broadcast"]
    assert [e.pair for e in ev] == [None, None, (4, 8), (0, 4), None]
    assert [e.nbytes for e in ev] == [30, 120, 30, 30, 30]
    assert {e.dtype for e in ev} == {"bfloat16"} and ev[0].ranks == g.ranks


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------


def test_matrix_on_4_gloo_ranks(tmp_path):
    """The two training entries across 4 ranks: the ring on rank pairs,
    the pipeline on (ens=2, pipe=2); every checked call clean, the pairs
    inside the rules, the comm one value on every rank."""
    outs = W.start("analysis", 4, str(tmp_path), {"dummy": np.zeros(1)},
                   timeout=150.0)()
    for r, out in enumerate(outs):
        assert int(out["train_chunk_world"]) == 2
        assert int(out["pipelined_train_world"]) == 4
        for name in ("train_chunk", "pipelined_train"):
            assert 1 <= int(out[f"{name}_compiles"]) <= 2
            assert int(out[f"{name}_calls"]) >= 1
            assert set(out[f"{name}_kinds"]) == {"all_reduce", "recv",
                                                 "send"}
            assert float(out[f"{name}_comm"]) == float(outs[0][f"{name}_comm"])
        pair = {r, r ^ 1}
        assert {tuple(p) for p in out["train_chunk_pairs"]} <= {
            (a, b) for a in pair for b in pair if a != b}
        pp = out["pipelined_train_pairs"]
        hops = {(int(a) - int(b)) for a, b in pp}
        assert all(a % 2 == b % 2 or abs(int(a) - int(b)) == 1
                   for a, b in pp)
        assert hops & {1, -1} and hops & {2, -2}


@pytest.fixture
def one_thread():
    """The matrix's models are tiny: one intra-op thread, as the gloo
    ranks run, so parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_runner_green_on_the_cpu_and_red_on_seeded_violations(
        tmp_path, monkeypatch, capsys, one_thread):
    """``python -m repro_torch.analysis --device cpu``: the lints clean
    modulo the baseline and the five entries passing at world 1; a stale
    waiver and a broken contract each make it fail."""
    assert runner.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("analysis: contract") == 5 and "analysis: OK" in out
    assert runner.MATRIX_ENTRIES == matrix.ENTRIES

    stale = tmp_path / "baseline.txt"
    stale.write_text(Path(runner.BASELINE).read_text()
                     + "host-sync:src/repro_torch/x.py:f:int()  # gone\n")
    assert runner.main(["--skip-contracts", "--baseline", str(stale)]) == 1

    def broken(device):
        raise tc.ContractViolation("scan_decode", ["seeded"])

    monkeypatch.setitem(matrix._CHECKS, "scan_decode", broken)
    assert runner.main(["--skip-lint", "--device", "cpu", "--entries",
                        "scan_decode"]) == 1


# ---------------------------------------------------------------------------
# the lints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["accumulator_bad.py",
                                  "accumulator_good.py", "threads_bad.py",
                                  "threads_good.py"])
def test_shared_rules_give_the_reference_keys(name):
    rules = ("f32-accumulator", "thread-discipline")
    ours = sorted(v.key for v in tlint.lint_file(FIXTURES / name, root=REPO)
                  if v.rule in rules)
    theirs = sorted(v.key for v in jlint.lint_file(FIXTURES / name,
                                                   root=REPO)
                    if v.rule in rules)
    assert ours == theirs
    assert bool(ours) == name.endswith("_bad.py")


def test_host_sync_fixture_pair():
    bad = {v.detail for v in tlint.lint_file(
        TORCH_FIXTURES / "hostsync_bad.py", root=REPO)}
    assert bad == {".item()", ".tolist()", ".cpu()", ".numpy()",
                   "cuda.synchronize", "int()", "float()", "if-tensor",
                   ".to(device)", "torch.tensor(device=)", "setitem-scalar"}
    assert tlint.lint_file(TORCH_FIXTURES / "hostsync_good.py",
                           root=REPO) == []


def test_port_is_clean_modulo_its_baseline():
    baseline = tlint.load_baseline(runner.BASELINE)
    remaining, stale = tlint.apply_baseline(tlint.lint_tree(REPO), baseline)
    assert remaining == [] and stale == []
    assert all(why for why in baseline.values())


def test_baseline_needs_justifications_and_goes_stale(tmp_path):
    bad = tmp_path / "b.txt"
    bad.write_text("host-sync:a.py:f:int()\n")
    with pytest.raises(ValueError, match="no justification"):
        tlint.load_baseline(bad)
    good = tmp_path / "g.txt"
    good.write_text("host-sync:a.py:f:int()  # a host int\n")
    remaining, stale = tlint.apply_baseline([], tlint.load_baseline(good))
    assert remaining == [] and stale == ["host-sync:a.py:f:int()"]
