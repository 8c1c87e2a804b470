"""The dry run (``repro_torch.launch.dryrun``) and its counting
(``launch/op_stats.py``, the kernels' meta routes), against the JAX
package where the reference computes the same figure.

* ``specs.input_specs`` on meta: the shapes and dtypes of
  ``repro.launch.specs.input_specs`` for a dense, an MoE, an
  encoder-decoder and an rwkv6 architecture, at every shape;
* ``n_params`` / ``n_active`` equal to the JAX dry run's for the same
  four; ``pipeline_report`` equal to JAX's at every figure for two
  architectures, and the CLI's ``--pp-stages`` lines equal to JAX's;
* the roofline helpers equal ``hlo_stats``'s on the same inputs, with
  the constants passed in;
* every kernel's meta route: empty outputs of the kernel's shapes and
  dtypes, the work of ``kernels/work.py``, which equals
  ``chip_smoke.py``'s bound formulas;
* the counting: FLOPs, bytes and the live-byte peak linear in depth for
  a homogeneous stack; ``--all`` writes a record for every architecture
  x shape (each ``ok`` with the record's fields, or skipped with the
  reference's reason), and nothing in it is made off ``meta``.
"""

import dataclasses
import io
import json
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.launch import hlo_stats
from repro.launch import specs as jspecs
from repro_torch.configs import INPUT_SHAPES, get_arch
from repro_torch.core.mixing import MixingConfig
from repro_torch.kernels import ops
from repro_torch.kernels import work
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_stats
from repro_torch.launch import specs

# the reference's dry run forces 512 placeholder devices through
# XLA_FLAGS when it is imported; the flag is put back at once, before
# anything here initializes a JAX backend
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

ARCHS = ("llama3.2-3b", "deepseek-v2-lite-16b", "whisper-medium",
         "rwkv6-3b")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    for jshape, shape in zip(JSHAPES, INPUT_SHAPES):
        want = _flat(jspecs.input_specs(jget_arch(arch), jshape))
        got = _flat(specs.input_specs(get_arch(arch), shape))
        assert sorted(want) == sorted(got), (arch, shape.name)
        for k, w in want.items():
            g = got[k]
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), (arch, shape.name, k)
            assert str(g.dtype).replace("torch.", "") == str(
                np.dtype(w.dtype)), (arch, shape.name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch):
    jp = JD.params_shapes(jget_arch(arch))
    tp = D.params_shapes(get_arch(arch))
    assert D._count(tp) == JD._count(jp)
    assert D.active_params(get_arch(arch), tp) == JD.active_params(
        jget_arch(arch), jp)


@pytest.mark.parametrize("arch, n, stages, kind", [
    ("llama3.2-3b", 2, 4, "wash"), ("deepseek-v2-lite-16b", 4, 3,
                                    "wash_opt")])
def test_pipeline_report_equals_the_reference(arch, n, stages, kind):
    assert D.pipeline_report(arch, n, stages, kind) == JD.pipeline_report(
        arch, n, stages, kind)


def test_pp_stages_cli_prints_the_reference_lines():
    rec = JD.pipeline_report("llama3.2-3b", 2, 4, "wash")
    want = (f"[pipeline] {rec['arch']} N=2 S=4 L={rec['num_layers']}: "
            + " ".join(f"s{i}={v:.3e}"
                       for i, v in enumerate(rec["per_stage_scalars"])))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert D.main(["--pp-stages", "4", "--arch", "llama3.2-3b",
                       "--wash", "2"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0] == want
    assert lines[1] == (f"[pipeline] total={rec['total_scalars']:.6e} (= sum "
                        f"of stages) vs single-stage "
                        f"{rec['single_stage_scalars']:.6e}")


def test_roofline_helpers_equal_hlo_stats():
    tpu = dict(peak_flops=hlo_stats.PEAK_FLOPS, hbm_bw=hlo_stats.HBM_BW,
               link_bw=hlo_stats.ICI_BW)
    rng = np.random.default_rng(0)
    for _ in range(6):
        flops, nbytes = float(rng.integers(1, 10 ** 15)), float(
            rng.integers(1, 10 ** 12))
        coll = {k: int(rng.integers(0, 10 ** 10)) for k in ("a", "b")}
        chips = int(rng.integers(1, 512))
        got = op_stats.roofline_terms(flops, nbytes, coll, chips, **tpu)
        assert got == hlo_stats.roofline_terms(flops, nbytes, coll, chips)
        assert op_stats.dominant_term(got) == hlo_stats.dominant_term(got)
        n = int(rng.integers(1, 10 ** 10))
        assert op_stats.model_flops(n, n // 3, 4096) == hlo_stats.model_flops(
            n, n // 3, 4096)
    assert (op_stats.PEAK_FLOPS, op_stats.HBM_BW, op_stats.LINK_BW) == (
        989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("S, causal, window", [
    (1, True, None), (37, True, None), (37, False, None), (37, True, 5),
    (37, False, 5), (64, True, 64), (64, False, 1)])
def test_visible_pairs_is_the_masks_count(S, causal, window):
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    visible = np.ones((S, S), bool)
    if causal:
        visible &= j <= i
    if window is not None:
        visible &= j > i - window
    assert work.visible_pairs(S, causal, window) == int(visible.sum())


def test_chip_smoke_bounds_are_the_dry_runs_counts():
    """``chip_smoke.py`` divides by ``kernels/work.py``'s counts, so the
    dry run and the bound table read the same work."""
    assert chip_smoke.flash_work(2, 64, 4, 2, 32, "bf16", True) == \
        work.flash_work(2, 64, 4, 2, 32, 2, True)
    assert chip_smoke.flash_work(1, 100, 8, 8, 64, "f32", False, 17, 32) == \
        work.flash_work(1, 100, 8, 8, 64, 4, False, 17, 32)
    assert chip_smoke.flash_work(1, 4, 1, 1, 2, "f32", True) == (
        4 * (4 * 1 * 4 + 4 * 1 * 4), 2 * 1 * 4 * 10)
    assert chip_smoke.wkv_work(2, 33, 4, 16) == work.wkv_work(2, 33, 4, 16)
    assert chip_smoke.wkv_bwd_work(2, 33, 4, 16, True) == \
        work.wkv_bwd_work(2, 33, 4, 16, True)
    assert chip_smoke.ssm_work(2, 33, 40, 16, True, backward=True) == \
        work.ssm_work(2, 33, 40, 16, True, True)
    assert chip_smoke.shuffle_bytes_dense(4, 1000, 2, 37) == \
        2 * 4 * 1000 * 2 + 1000 + 4 * 4 * 37
    assert chip_smoke.shuffle_bytes_bucketed(3, 99, 4) == \
        2 * 3 * 2 * 99 * 4 + 4 * 2 * 99
    assert work.visible_pairs(1 << 19, True, 8192) == (
        8192 * 8193 // 2 + ((1 << 19) - 8192) * 8192)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_every_kernel_has_a_meta_route():
    seen = []
    ops.work_counters.append(lambda *a: seen.append(a))
    try:
        x = _meta(3, 50, dtype=torch.bfloat16)
        out = ops.wash_shuffle(x, _meta(3, 50, dtype=torch.int32),
                               _meta(50, dtype=torch.bool))
        assert out.shape == x.shape and out.dtype == x.dtype
        assert ops.bucketed_shuffle_(x, _meta(3, 7, dtype=torch.int32)) is x
        q = _meta(4, 8, 32, dtype=torch.bfloat16)
        pool = _meta(9, 16, 2, 32, dtype=torch.bfloat16)
        o = ops.paged_attention(q, pool, pool, _meta(4, 3, dtype=torch.int32),
                                _meta(4, dtype=torch.int32))
        assert o.shape == q.shape and o.dtype == q.dtype
        qf = _meta(2, 64, 6, 192)
        o = ops.flash_attention(qf, _meta(2, 64, 2, 192), _meta(2, 64, 2, 128))
        assert o.shape == (2, 64, 6, 128)
        r = _meta(2, 10, 4, 16).requires_grad_()
        u = _meta(4, 16).requires_grad_()
        y, s = ops.rwkv6_scan(r, r, r, r, u, state=_meta(2, 4, 16, 16))
        assert y.shape == r.shape and s.shape == (2, 4, 16, 16)
        y.sum().backward()
        assert r.grad.shape == r.shape and u.grad.shape == u.shape
        uu = _meta(2, 10, 40).requires_grad_()
        bc = _meta(2, 10, 16)
        y = ops.selective_scan(uu, uu, bc, bc, _meta(40, 16))
        assert y.shape == uu.shape and y.dtype == torch.float32
        y.sum().backward()
        assert uu.grad.shape == uu.shape
    finally:
        ops.work_counters.pop()
    names = [s[0] for s in seen]
    assert names == ["wash_shuffle", "bucketed_shuffle", "paged_attention",
                     "flash_attention", "rwkv6_scan", "rwkv6_scan_bwd",
                     "selective_scan", "selective_scan_bwd"]
    assert seen[0][1:] == (work.shuffle_bytes_dense(3, 50, 2, 50), 0)
    assert seen[2][1:] == work.paged_work_most(4, 8, 2, 32, 16, 3, 2, 2,
                                               False)
    assert seen[3][1:] == work.flash_work(2, 64, 6, 2, 192, 4, True, None,
                                          128)
    assert seen[5][1:] == work.wkv_bwd_work(2, 10, 4, 16, True)
    assert seen[7][1:] == work.ssm_work(2, 10, 40, 16, False, backward=True)


def test_counts_are_linear_in_depth():
    """A homogeneous stack: each layer adds the same FLOPs, bytes and
    live bytes at the peak (llama3.2-3b's widths, one row of 32 tokens,
    SGD, no mixing)."""
    base = get_arch("llama3.2-3b")
    figs = []
    for d in (1, 2, 3):
        acc = D.account_train(D.depth_variant(base, d), 1, 32, {"ens": 1}, 1,
                              MixingConfig(kind="none"), "sgd")
        c = acc["counter"]
        figs.append((c.flops, c.bytes, c.peak_bytes, acc["resident"]))
    for i in range(4):
        assert figs[2][i] - figs[1][i] == figs[1][i] - figs[0][i] > 0, i


class _Devices(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


FIELDS = ("n_params", "n_active", "tokens", "model_flops", "counted_flops",
          "counted_bytes", "bytes_all_reduce", "bytes_all_gather",
          "bytes_send", "bytes_recv", "bytes_broadcast", "compute_s",
          "memory_s", "collective_s", "dominant", "useful_flops_ratio",
          "per_card_bytes", "fits")


def test_all_writes_every_pair_on_meta_only(tmp_path):
    """``--all`` (every arch cut to one layer, to stay cheap): a record
    for each of the 40 pairs, ``ok`` with every field or skipped with
    the reference's reason, and every tensor made on ``meta``."""
    mode = _Devices()
    buf = io.StringIO()
    with mode, redirect_stdout(buf):
        rc = D.main(["--all", "--layers", "1", "--out-dir", str(tmp_path)])
    assert rc == 0, buf.getvalue()
    assert mode.devices == {"meta"}
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 40
    for rec in recs:
        if rec["status"] == "skip":
            assert rec["shape"] == "long_500k"
            assert rec["note"] == JD.LONG_SKIP[rec["arch"]]
            continue
        assert rec["status"] == "ok", rec
        for f in FIELDS:
            assert f in rec, (rec["arch"], rec["shape"], f)
        assert rec["num_layers"] == 1
    assert sum(r["status"] == "skip" for r in recs) == len(JD.LONG_SKIP)


def test_wash_pair_records_the_ring_and_refuses_hints(tmp_path):
    rec = D.account_pair("llama3.2-3b", "train_4k", False, wash=2,
                         mixing_kind="wash_opt_local", layers=1)
    assert rec["status"] == "ok" and rec["collective_counts"]["send"] > 0
    assert rec["collective_dtypes"]["send"] == ["bfloat16", "float32"]
    assert rec["comm_scalars_per_member"] > 0
    with pytest.raises(SystemExit):
        D.main(["--arch", "llama3.2-3b", "--shape", "train_4k", "--hints",
                "--out-dir", str(tmp_path)])
