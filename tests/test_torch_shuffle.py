"""The port's plan geometry and stacked shuffle against the JAX package.

* ``core/schedules.py`` and ``core/layer_index.py``: exactly equal.
* Plans built by JAX cross to the port as arrays; ``apply_plan_stacked``
  on dense, bucketed and layered plans is bitwise JAX's, float32 and
  bfloat16.  The selected counts are equal; the port's sent count is
  float64 and exact, the reference's dense count float32 (within 2**-23).
* Plan shapes and ``static_mix_comm`` come from shapes alone and equal
  JAX's, on llama3.2-3b at full width too (JAX via ``eval_shape``).
* The port's own RNG-driven plan functions draw other numbers than
  ``jax.random`` and are held to ``tests/test_wash_properties.py``'s
  contracts instead: distance preservation (Eq. 5, rtol 1e-5 in float32),
  per-coordinate permutation (exact), unique in-range indices, p·d volume
  (within 5%), the layered depth profile, determinism given the seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import layer_index as jli
from repro.core import mixing as jmix
from repro.core import schedules as jsch
from repro.core import shuffle as jshf
from repro.models import transformer as JM
from repro_torch.configs import get_arch
from repro_torch.core import layer_index as li
from repro_torch.core import population as pop
from repro_torch.core import schedules as sch
from repro_torch.core import shuffle as shf
from repro_torch.core.consensus import sq_distance_to_consensus
from repro_torch.core.mixing import MixingConfig, static_mix_comm
from repro_torch.models import transformer as TM
from repro_torch.train.interop import params_from_numpy, tensor_to_numpy

N = 3


def _to_torch_plan(plan):
    """A JAX plan tree (None / array / (perm, mask) leaves) as tensors."""
    nplan = jax.tree_util.tree_map(np.array, plan)
    return pop.tree_map(lambda a: None if a is None else torch.from_numpy(a),
                        nplan)


def _jax_population(dtype="float32", seed=0):
    cfg = jget_arch("llama3.2-3b").reduced(dtype=dtype)
    member = JM.init_params(jax.random.key(seed), cfg)
    keys = jax.random.split(jax.random.key(seed + 1), N)
    # members differ, so a shuffle moves something visible
    popn = jax.tree_util.tree_map(
        lambda x: (jnp.broadcast_to(x[None], (N,) + x.shape)
                   + jax.vmap(lambda k: 0.1 * jax.random.normal(
                       k, x.shape))(keys)).astype(x.dtype), member)
    return cfg, popn


def _bits(a) -> np.ndarray:
    a = tensor_to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# ---------------------------------------------------------------------------
# schedules, layer ids: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["decreasing", "constant", "increasing"])
def test_schedules_equal_jax(schedule):
    for total in (1, 2, 5, 30):
        for depth in range(total):
            assert sch.layer_probability(0.01, depth, total, schedule) == \
                jsch.layer_probability(0.01, depth, total, schedule)
        depths = np.arange(1, total + 1)
        np.testing.assert_array_equal(
            sch.layer_probability_array(0.3, depths, total, schedule),
            jsch.layer_probability_array(0.3, depths, total, schedule))
    with pytest.raises(ValueError):
        sch.layer_probability(0.1, 1, 4, "sideways")
    for step, start, stop in [(0, 0, None), (3, 5, None), (5, 2, 5), (4, 2, 5)]:
        assert sch.active_window(step, start, stop) == \
            jsch.active_window(step, start, stop)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_infer_layer_ids_equal_jax(reduced):
    jcfg, tcfg = jget_arch("llama3.2-3b"), get_arch("llama3.2-3b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jparams = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    want = jli.infer_layer_ids(jparams, jcfg.num_layers)
    got = li.infer_layer_ids(TM.param_shapes(tcfg), tcfg.num_layers)
    wpaths = jax.tree_util.tree_flatten_with_path(want)[0]
    gpaths = list(pop.tree_paths(got))
    assert len(wpaths) == len(gpaths) == 12
    for (jp, jv), (tp, tv) in zip(wpaths, gpaths):
        assert [getattr(e, "key", None) for e in jp] == list(tp)
        np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
    assert li.total_layers(tcfg.num_layers) == jli.total_layers(jcfg.num_layers)


def test_leaf_depth_equal_jax_on_list_blocks():
    tree = {"embed": {"w": 0}, "blocks": [{"w1": 0}, {"w1": 0}],
            "head": {"w": 0}, "stages": {"s3": 0}, "tok_emb": 0}
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for (jp, _), (tp, _) in zip(jflat, pop.tree_paths(tree)):
        assert li.leaf_depth(tp, 4) == jli.leaf_depth(jp, 4)


# ---------------------------------------------------------------------------
# plan shapes and comm accounting from shapes
# ---------------------------------------------------------------------------


def _jax_plan_shapes(jcfg, n, base_p, schedule="decreasing"):
    member = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    lids = jli.infer_layer_ids(member, jcfg.num_layers)
    tl = jli.total_layers(jcfg.num_layers)
    plan = jax.eval_shape(lambda: jshf.make_plan(
        jax.random.key(0), member, lids, tl, base_p, schedule,
        mode="bucketed", n=n))
    return [None if p is None else p.shape[1] for p in
            jax.tree_util.tree_leaves(plan, is_leaf=lambda x: x is None)]


def test_full_width_plan_sizes_and_comm_equal_jax():
    tcfg, jcfg = get_arch("llama3.2-3b"), jget_arch("llama3.2-3b")
    shapes = TM.param_shapes(tcfg)
    lids = li.infer_layer_ids(shapes, tcfg.num_layers)
    tl = li.total_layers(tcfg.num_layers)
    got = shf.bucketed_plan_sizes(shapes, lids, tl, 0.01, "decreasing", 2)
    assert got == _jax_plan_shapes(jcfg, 2, 0.01)
    named = dict(zip(["/".join(map(str, p)) for p, _ in pop.tree_paths(shapes)],
                     got))
    assert sum(k is not None for k in got) == 10
    assert named["final_norm/scale"] is None and named["lm_head/w"] is None
    assert named["blocks/mlp/w1"] == named["blocks/mlp/w2"] == 1761607
    assert named["embed/tok"] == 1970012
    assert named["blocks/attn/wq"] == named["blocks/attn/wo"] == 660602
    assert named["blocks/attn/wk"] == 220201 and named["blocks/ln1/scale"] == 214
    assert 2 * sum(k for k in got if k) == 18033734

    mcfg = MixingConfig(kind="wash", base_p=0.01, mode="bucketed")
    comm = static_mix_comm(shapes, mcfg, lids, tl, 2)
    assert comm == 9016867.0
    jmember = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    jcomm = jmix.static_mix_comm(
        jmember, jmix.MixingConfig(kind="wash", base_p=0.01, mode="bucketed"),
        jli.infer_layer_ids(jmember, jcfg.num_layers), tl, 2)
    assert comm == jcomm


@pytest.mark.parametrize("mode", ["dense", "bucketed"])
def test_port_plans_have_jax_plan_shapes(mode):
    cfg, jpopn = _jax_population()
    tpopn = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpopn), "cpu")
    jl = jli.infer_layer_ids(jax.tree_util.tree_map(lambda x: x[0], jpopn),
                             cfg.num_layers)
    tl = li.infer_layer_ids(pop.member(tpopn, 0), cfg.num_layers)
    total = li.total_layers(cfg.num_layers)
    want = jshf.make_plan(jax.random.key(1), jpopn, jl, total, 0.2, mode=mode)
    got = shf.make_plan(7, tpopn, tl, total, 0.2, mode=mode)
    wl = jax.tree_util.tree_leaves(want, is_leaf=lambda x: x is None
                                   or isinstance(x, tuple))
    gl = pop.tree_leaves(got, is_leaf=lambda x: x is None or isinstance(x, tuple))
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert (w is None) == (g is None)
        if w is None:
            continue
        if mode == "dense":
            assert g[0].shape == w[0].shape and g[1].shape == w[1].shape
            assert g[0].dtype == torch.int32 and g[1].dtype == torch.bool
        else:
            assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.int32


# ---------------------------------------------------------------------------
# apply on JAX plans: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dense", "bucketed"])
def test_apply_plan_stacked_on_jax_plans_bitwise(mode, dtype):
    """The llama tree holds layered (stacked-blocks) and flat leaves."""
    cfg, jpopn = _jax_population(dtype)
    lids = jli.infer_layer_ids(jax.tree_util.tree_map(lambda x: x[0], jpopn),
                               cfg.num_layers)
    plan = jshf.make_plan(jax.random.key(3), jpopn, lids,
                          jli.total_layers(cfg.num_layers), 0.4, mode=mode)
    want = jshf.apply_plan_stacked(plan, jpopn, mode)
    tpopn = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpopn), "cpu")
    tplan = _to_torch_plan(plan)
    got = shf.apply_plan_stacked(tplan, tpopn, mode)
    assert got is tpopn or got == tpopn
    for (path, g), w in zip(pop.tree_paths(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))
    sent = shf.plan_sent_scalars(tplan, N, mode)
    jsel = int(jshf.plan_selected_scalars(plan, mode))
    assert int(shf.plan_selected_scalars(tplan, mode)) == jsel
    assert float(sent) == jsel * (N - 1) / N  # exact, in float64
    # the reference's count is float32: equal within its rounding
    np.testing.assert_allclose(float(sent),
                               float(jshf.plan_sent_scalars(plan, N, mode)),
                               rtol=2 ** -23)
    if mode == "dense":
        assert torch.is_tensor(sent) and sent.dtype == torch.float64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_apply_is_in_place_and_one_call_a_tree(dtype, monkeypatch):
    """WASH+Opt's dense step: the plan applied to the params and then to
    each moment tree (AdamW's mu and nu) through ``apply_plan_stacked``,
    in place, one ``ops.wash_shuffle_many_`` call a tree, every leaf
    bitwise JAX's ``apply_plan_stacked`` on the same arrays."""
    from repro_torch.kernels import ops

    cfg, jpopn = _jax_population(dtype)
    lids = jli.infer_layer_ids(jax.tree_util.tree_map(lambda x: x[0], jpopn),
                               cfg.num_layers)
    plan = jshf.make_plan(jax.random.key(4), jpopn, lids,
                          jli.total_layers(cfg.num_layers), 0.4, mode="dense")
    rng = np.random.default_rng(5)
    jmoments = [jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32),
        jpopn) for _ in range(2)]
    tplan = _to_torch_plan(plan)
    calls = []
    route = ops.wash_shuffle_many_

    def counted(xs, perms, masks):
        calls.append(len(xs))
        return route(xs, perms, masks)

    monkeypatch.setattr(ops, "wash_shuffle_many_", counted)
    planned = sum(p is not None for p in jax.tree_util.tree_leaves(
        plan, is_leaf=lambda x: x is None or isinstance(x, tuple)))
    for jtree in [jpopn] + jmoments:
        want = jshf.apply_plan_stacked(plan, jtree, "dense")
        ttree = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                  "cpu")
        storages = [t.data_ptr() for t in pop.tree_leaves(ttree)]
        shf.apply_plan_stacked(tplan, ttree, "dense")
        assert [t.data_ptr() for t in pop.tree_leaves(ttree)] == storages
        for (path, g), w in zip(pop.tree_paths(ttree),
                                jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=str(path))
    assert calls == [planned] * 3


def test_functional_applies_leave_the_leaf():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, 4, 5)).astype(np.float32))
    before = x.clone()
    perm, mask = shf.dense_plan(1, (4, 5), N, 0.5, "cpu")
    out = shf.dense_apply(x, perm, mask)
    idx = shf.bucketed_plan(2, 20, N, 0.6, device="cpu")
    out2 = shf.bucketed_apply_stacked(x, idx)
    assert torch.equal(x, before) and out.shape == out2.shape == x.shape
    assert not torch.equal(out, x) and not torch.equal(out2, x)


# ---------------------------------------------------------------------------
# the port's own plan functions: the reference's contracts
# ---------------------------------------------------------------------------

CASES = [(2, 1, 1.0, 0), (3, 37, 0.3, 1), (4, 300, 0.05, 2), (8, 257, 0.9, 3),
         (5, 128, 0.5, 4)]


@pytest.mark.parametrize("n,d,p,seed", CASES)
def test_dense_plan_preserves_distance_and_coordinate_multisets(n, d, p, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32))
    perm, mask = shf.dense_plan(seed, (d,), n, p, "cpu")
    assert torch.equal(torch.sort(perm.long(), dim=0).values,
                       torch.arange(n)[:, None].expand(n, d))
    out = shf.dense_apply(x, perm, mask)
    np.testing.assert_allclose(float(sq_distance_to_consensus({"x": out})),
                               float(sq_distance_to_consensus({"x": x})),
                               rtol=1e-5)
    assert torch.equal(torch.sort(out, dim=0).values,
                       torch.sort(x, dim=0).values)
    assert torch.equal(out[:, ~mask], x[:, ~mask])


@pytest.mark.parametrize("n,d,p,seed", CASES)
def test_bucketed_plan_preserves_distance_and_coordinate_multisets(n, d, p, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32))
    idx = shf.bucketed_plan(seed, d, n, p, device="cpu")
    if idx is None:
        assert shf.bucket_count(d, n, p) == 0
        return
    flat = idx.reshape(-1)
    assert len(torch.unique(flat)) == flat.numel()
    assert int(flat.min()) >= 0 and int(flat.max()) < d
    out = shf.bucketed_apply_stacked(x, idx)
    np.testing.assert_allclose(float(sq_distance_to_consensus({"x": out})),
                               float(sq_distance_to_consensus({"x": x})),
                               rtol=1e-5)
    assert torch.equal(torch.sort(out, dim=0).values,
                       torch.sort(x, dim=0).values)


def test_plans_are_deterministic_given_the_seed():
    a, b, c = (shf.bucketed_plan(s, 500, 4, 0.2, device="cpu")
               for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    (p1, m1), (p2, m2) = (shf.dense_plan(7, (50,), 4, 0.3, "cpu")
                          for _ in range(2))
    assert torch.equal(p1, p2) and torch.equal(m1, m2)


def test_bucketed_comm_volume_is_p_d():
    n, d, p = 4, 10000, 0.05
    sent = shf.plan_sent_scalars(
        {"w": shf.bucketed_plan(0, d, n, p, device="cpu")}, n, "bucketed")
    expect = p * d * (n - 1) / n
    assert abs(sent - expect) / expect < 0.05


def test_dense_mask_rate_is_p():
    _, mask = shf.dense_plan(4, (20000,), 3, 0.25, "cpu")
    assert abs(float(mask.float().mean()) - 0.25) < 0.02


def test_stratified_indices_stay_unique_past_int32_products():
    """d and k of a full-width llama3.2-3b w1 layer: i * d passes 2**31
    (the reference wraps there, ROADMAP §3); the port's stay in range."""
    d, k = 3072 * 8192, 251658
    idx = shf.stratified_unique_indices(11, d, k, "cpu")
    assert idx.dtype == torch.int32 and idx.numel() == k
    assert int(idx.min()) >= 0 and int(idx.max()) < d
    assert len(torch.unique(idx)) == k
    starts = (torch.arange(k) * d) // k  # one index per stratum
    strata = torch.searchsorted(starts, idx.long(), right=True) - 1
    assert torch.equal(torch.sort(strata).values, torch.arange(k))


def test_layered_bucketed_depth_profile():
    L, d_rest, n = 8, 512, 4
    p_vec = sch.layer_probability_array(0.5, np.arange(1, L + 1), L + 2,
                                        "decreasing")
    plan = shf.bucketed_plan_layered(0, L, d_rest, n, p_vec, device="cpu")
    counts = np.bincount(plan.reshape(-1).numpy() // d_rest, minlength=L)
    want = shf.layered_counts(L, d_rest, p_vec)
    assert plan.shape == (n, sum(want) // n)
    assert np.all(counts <= np.asarray(want))
    assert counts[0] > counts[-1]
    assert counts[0] >= counts[L // 2] >= counts[-1] - 2
    flat = plan.reshape(-1)
    assert len(torch.unique(flat)) == flat.numel()


def test_dense_layered_plan_gates_each_layer_with_its_probability():
    p_vec = np.array([0.9, 0.5, 0.0])
    perm, mask = shf.dense_plan_layered(3, (3, 4000), 2, p_vec, "cpu")
    rates = mask.float().mean(dim=1).numpy()
    np.testing.assert_allclose(rates, p_vec, atol=0.03)
    assert perm.shape == (2, 3, 4000)


def test_make_plan_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        shf.make_plan(0, {"w": torch.zeros(2, 3)}, {"w": 0}, 3, 0.5,
                      mode="sparse")


# ---------------------------------------------------------------------------
# bucketed plans drawn with each row in ascending order
# ---------------------------------------------------------------------------

def _layered_plan(seed, n=4):
    L, d_rest = 8, 512
    p_vec = sch.layer_probability_array(0.5, np.arange(1, L + 1), L + 2,
                                        "decreasing")
    return shf.bucketed_plan_layered(seed, L, d_rest, n, p_vec, device="cpu")


def _plans():
    for n, d, p, seed in CASES:
        yield f"flat n={n} d={d}", shf.bucketed_plan(seed, d, n, p,
                                                     device="cpu")
    for n in (2, 3, 4, 8):
        yield f"layered n={n}", _layered_plan(n, n)


def test_bucketed_plan_rows_are_strictly_ascending_and_disjoint():
    for what, idx in _plans():
        if idx is None:
            continue
        assert bool((idx[:, 1:] > idx[:, :-1]).all()), what
        flat = idx.reshape(-1)
        assert len(torch.unique(flat)) == flat.numel(), what


@pytest.mark.parametrize("n,d,p,seed", CASES)
def test_bucketed_plan_sizes_are_as_drawn(n, d, p, seed):
    """k_per = round(p d) // n per row (or no plan), and the rows together
    are the stratified draw: one coordinate per stratum."""
    idx = shf.bucketed_plan(seed, d, n, p, device="cpu")
    k_per = shf.bucket_count(d, n, p)
    if k_per == 0:
        assert idx is None
        return
    assert idx.shape == (n, k_per) and idx.dtype == torch.int32
    k = n * k_per
    starts = (torch.arange(k) * d) // k
    strata = torch.searchsorted(starts, idx.reshape(-1).long(), right=True) - 1
    assert torch.equal(torch.sort(strata).values, torch.arange(k))


def test_layered_plan_keeps_the_depth_profile_and_size():
    L, d_rest, n = 8, 512, 3  # a pool of 1024: one coordinate dropped
    p_vec = sch.layer_probability_array(0.5, np.arange(1, L + 1), L + 2,
                                        "decreasing")
    want = shf.layered_counts(L, d_rest, p_vec)
    dropped = []
    for seed in range(20):
        plan = shf.bucketed_plan_layered(seed, L, d_rest, n, p_vec,
                                         device="cpu")
        assert plan.shape == (n, sum(want) // n)
        counts = np.bincount(plan.reshape(-1).numpy() // d_rest, minlength=L)
        assert np.all(counts <= np.asarray(want))
        dropped.append(np.asarray(want) - counts)
    # the remainder of N is dropped at random, not always from one layer
    assert sum(want) % n and len({tuple(x) for x in dropped}) > 1


@pytest.mark.parametrize("layered", [False, True], ids=["flat", "layered"])
def test_each_coordinate_lands_in_each_bucket_uniformly(layered):
    """Over 400 seeds, the bucket each pool coordinate lands in (or its
    drop, for the layered pool's remainder) follows k_per / pool size per
    bucket: a loose chi-square check (statistic below its mean plus 6
    standard deviations)."""
    n, seeds = 4, 400
    if layered:
        L, d_rest = 2, 13      # p = 1: a pool of 26, k_per 6, 2 dropped
        pool = list(range(L * d_rest))
        draw = lambda s: shf.bucketed_plan_layered(  # noqa: E731
            s, L, d_rest, n, [1.0, 1.0], device="cpu")
    else:
        d = 40                                   # p = 1: the pool is all of d
        pool = list(range(d))
        draw = lambda s: shf.bucketed_plan(s, d, n, 1.0, device="cpu")  # noqa
    where = {c: i for i, c in enumerate(pool)}
    hits = np.zeros((len(pool), n + 1))
    for s in range(seeds):
        idx = draw(s).numpy()
        landed = np.full(len(pool), n)
        for row in range(n):
            landed[[where[c] for c in idx[row]]] = row
        hits[np.arange(len(pool)), landed] += 1
    k_per = len(pool) // n
    expect = np.full(n + 1, k_per / len(pool))
    expect[n] = 1 - n * k_per / len(pool)
    live = expect > 0
    e = seeds * expect[live]
    chi2 = float((((hits[:, live] - e) ** 2) / e).sum())
    dof = len(pool) * (live.sum() - 1)
    assert chi2 < dof + 6 * np.sqrt(2 * dof), (chi2, dof)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_bucketed_apply_ignores_the_order_within_rows(n, dtype):
    """The rows are disjoint, so a plan and a copy of it with each row
    shuffled move the same bits (the plain version)."""
    d = 997
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, d)).astype(np.float32)).to(dtype)
    idx = shf.bucketed_plan(n, d, n, 0.4, device="cpu")
    gen = torch.Generator().manual_seed(n)
    shuffled = torch.stack([row[torch.randperm(row.numel(), generator=gen)]
                            for row in idx])
    assert not torch.equal(shuffled, idx)
    a = shf.bucketed_apply_stacked(x, idx)
    b = shf.bucketed_apply_stacked(x, shuffled)
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32))
