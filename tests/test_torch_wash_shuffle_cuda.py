"""The CUDA WASH-shuffle kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card, where neither is installed (``tests/conftest.py`` imports JAX,
hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_wash_shuffle_cuda.py

Without a card every test here skips.  Tolerance: none.  Both kernels are
pure data movement, so their results are compared bit for bit with the
plain versions (float32, bfloat16, float16), including a leaf of more
than 2**31 elements, where 32-bit offsets would wrap.  The dense kernel
is also held grouped and in place: leaves of mixed widths and word sizes
in one call (vector path, scalar path), a leaf off 16 bytes, more leaves
than one launch takes.
"""

import subprocess
import sys

import pytest
import torch

from repro_torch.core import shuffle as shf
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wash_shuffle as ws

D = 100_003  # not a multiple of any block
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _leaf(n, d, dtype, device, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(n, d, generator=gen, device=device).to(dtype)


def _dense_plan(n, d, device, seed=1):
    perm, mask = shf.dense_plan(seed, (d,), n, 0.3, device)
    return perm, mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
def test_dense_kernel_is_bitwise_the_plain_version(cuda_device, n, dtype):
    x = _leaf(n, D, dtype, cuda_device)
    perm, mask = _dense_plan(n, D, cuda_device)
    n0 = ws.wash_launches
    got = ops.wash_shuffle(x, perm, mask)
    assert ws.wash_launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16 if dtype != torch.float32
                                else torch.int32),
                       ref.wash_shuffle_ref(x, perm, mask).view(
                           torch.int16 if dtype != torch.float32
                           else torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
def test_bucketed_kernel_is_bitwise_the_plain_version(cuda_device, n, dtype):
    x = _leaf(n, D, dtype, cuda_device)
    idx = shf.bucketed_plan(2, D, n, 0.5, device=cuda_device)
    want = ref.bucketed_shuffle_ref(x, idx)
    n0 = ws.bucketed_launches
    got = ops.bucketed_shuffle_(x, idx)
    assert got is x and ws.bucketed_launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(x, want)  # data movement: equal values, equal bits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
def test_bucketed_kernel_on_sorted_and_shuffled_rows(cuda_device, n, dtype):
    """core.shuffle draws each row ascending; the kernel gives the same
    bits on a copy with every row shuffled (JAX plans cross over
    unsorted), and both equal the plain version."""
    x = _leaf(n, D, dtype, cuda_device, seed=n)
    idx = shf.bucketed_plan(n + 7, D, n, 0.2, device=cuda_device)
    assert bool((idx[:, 1:] > idx[:, :-1]).all())
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n)
    shuffled = torch.stack([row[torch.randperm(row.numel(), generator=gen,
                                               device=cuda_device)]
                            for row in idx]).contiguous()
    want = ref.bucketed_shuffle_ref(x, idx)
    a = ws.bucketed_shuffle_cuda_(x.clone(), idx)
    b = ws.bucketed_shuffle_cuda_(x.clone(), shuffled)
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(a.view(bits), want.view(bits))
    assert torch.equal(b.view(bits), want.view(bits))


@pytest.mark.gpu
def test_both_kernels_past_two_to_the_31_elements(cuda_device):
    """N * D = 4 * (2**29 + 7) > 2**31 bfloat16 elements (4.3 GB)."""
    n, d = 4, 2 ** 29 + 7
    x = _leaf(n, d, torch.bfloat16, cuda_device, seed=3)
    # bucketed: columns near the end put offsets (n-1)*d + c past 2**31
    cols = torch.arange(d - 4096, d, device=cuda_device, dtype=torch.int32)
    idx = cols[torch.randperm(4096, device=cuda_device)].reshape(n, -1)
    idx = idx.contiguous()
    want = ref.bucketed_shuffle_ref(x[:, d - 4096:].clone(),
                                    (idx - (d - 4096)).contiguous())
    ws.bucketed_shuffle_cuda_(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(x[:, d - 4096:], want)
    # dense over the whole leaf; cyclic shifts are permutations and cheap
    # to draw (an argsort of (n, d) uniforms would take ~40 GB)
    shift = torch.randint(0, n, (d,), dtype=torch.int32, device=cuda_device)
    rows = torch.arange(n, dtype=torch.int32, device=cuda_device)[:, None]
    perm = (rows + shift) % n
    mask = torch.rand(d, device=cuda_device) < 0.01
    got = ws.wash_shuffle_cuda(x, perm, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.wash_shuffle_ref(x, perm, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "bucketed"])
def test_apply_plan_stacked_on_the_card_matches_the_cpu(cuda_device, mode):
    leaf = _leaf(3, 4 * 777, torch.bfloat16, cuda_device).reshape(3, 4, 777)
    tree = {"blocks": {"w": leaf.clone()}, "embed": {"tok": leaf[:, 0].clone()}}
    lids = {"blocks": {"w": torch.arange(1, 5).numpy()}, "embed": {"tok": 0}}
    plan = shf.make_plan(5, tree, lids, 6, 0.5, mode=mode)
    cpu_plan = {k: {kk: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
                         else v.cpu()) for kk, v in d.items()}
                for k, d in plan.items()}
    cpu_tree = {k: {kk: v.cpu() for kk, v in d.items()} for k, d in tree.items()}
    counts = (ws.wash_launches, ws.bucketed_launches, ws.wash_leaves)
    shf.apply_plan_stacked(plan, tree, mode)
    shf.apply_plan_stacked(cpu_plan, cpu_tree, mode)
    launched = (ws.wash_launches - counts[0], ws.bucketed_launches - counts[1])
    # dense: both bf16 leaves in one launch, in place
    assert launched == ((1, 0) if mode == "dense" else (0, 2))
    assert ws.wash_leaves - counts[2] == (2 if mode == "dense" else 0)
    for k in tree:
        for kk in tree[k]:
            assert torch.equal(tree[k][kk].cpu(), cpu_tree[k][kk])


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = _leaf(3, 64, torch.float32, cuda_device)
    perm, mask = _dense_plan(3, 64, cuda_device)
    with pytest.raises(ValueError, match="int32"):
        ws.wash_shuffle_cuda(x, perm.long(), mask)
    with pytest.raises(ValueError, match="bool"):
        ws.wash_shuffle_cuda(x, perm, mask.int())
    with pytest.raises(ValueError, match="contiguous"):
        ws.wash_shuffle_cuda(x.t().contiguous().t(), perm, mask)
    with pytest.raises(ValueError, match="members"):
        ws.bucketed_shuffle_cuda_(_leaf(17, 8, torch.float32, cuda_device),
                                  torch.zeros(17, 0, dtype=torch.int32,
                                              device=cuda_device))
    with pytest.raises(ValueError, match="dtype"):
        ws.bucketed_shuffle_cuda_(x.double(), torch.zeros(
            3, 1, dtype=torch.int32, device=cuda_device))


_OUT_OF_RANGE = """
import torch
from repro_torch.kernels import wash_shuffle as ws
x = torch.zeros(3, 64, device="cuda")
if {bucketed}:
    ws.bucketed_shuffle_cuda_(x, torch.tensor([[0], [5], [64]],
                                              dtype=torch.int32, device="cuda"))
else:
    ws.wash_shuffle_cuda(x, torch.full((3, 64), 3, dtype=torch.int32,
                                       device="cuda"),
                         torch.ones(64, dtype=torch.bool, device="cuda"))
torch.cuda.synchronize()
print("no error")
"""


@pytest.mark.gpu
@pytest.mark.parametrize("bucketed", [True, False], ids=["bucketed", "dense"])
def test_a_plan_entry_out_of_range_fails_the_launch(cuda_device, bucketed):
    """A column past the leaf (bucketed) or a perm entry past N (dense)
    stops the kernel with a trap: a CUDA error, never a silent skip.  In a
    child process, since a trap leaves its CUDA context unusable."""
    proc = subprocess.run(
        [sys.executable, "-c", _OUT_OF_RANGE.format(bucketed=bucketed)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0, proc.stdout
    assert "no error" not in proc.stdout
    assert "CUDA error" in proc.stderr, proc.stderr[-2000:]


def _grouped(device, dtypes, widths, n, seed):
    """Leaves of every (dtype, width), their dense plans, and the plain
    version's result for each (computed before the in-place call)."""
    xs, perms, masks, wants = [], [], [], []
    for i, (dtype, d) in enumerate((dt, d) for dt in dtypes for d in widths):
        x = _leaf(n, d, dtype, device, seed=seed + i)
        perm, mask = shf.dense_plan(seed + i, (d,), n, 0.3, device)
        xs.append(x)
        perms.append(perm)
        masks.append(mask)
        wants.append(ref.wash_shuffle_ref(x, perm, mask))
    return xs, perms, masks, wants


def _bitwise(a, b) -> bool:
    bits = torch.int32 if a.element_size() == 4 else torch.int16
    return torch.equal(a.view(bits), b.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 3, 16])
def test_grouped_in_place_is_bitwise_the_plain_version(cuda_device, n):
    """One call, leaves of 1 .. 100,003 columns in f32, bf16 and f16: the
    vector path (whole 16-byte rows) and the scalar path (7, 4099, D) in
    one launch a word size (f16 and bf16 are both 2-byte words), each leaf
    shuffled where it lies."""
    widths = (1, 7, 64, 1000, 4099, 4096, D)
    xs, perms, masks, wants = _grouped(cuda_device, DTYPES, widths, n, 10)
    ptrs = [x.data_ptr() for x in xs]
    n0 = (ws.wash_launches, ws.wash_leaves)
    ops.wash_shuffle_many_(xs, perms, masks)
    torch.cuda.synchronize()
    assert (ws.wash_launches - n0[0], ws.wash_leaves - n0[1]) == \
        (2, len(xs))
    assert [x.data_ptr() for x in xs] == ptrs
    for x, want in zip(xs, wants):
        assert _bitwise(x, want), (x.dtype, x.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_a_leaf_off_16_bytes_takes_the_scalar_path(cuda_device, dtype):
    """A contiguous (N, D) view one element into its storage (x, and the
    plan's perm and mask likewise): every row off 16 bytes."""
    n, d = 3, 4096
    base = _leaf(1, n * d + 1, dtype, cuda_device, seed=5)[0]
    x = base[1:].view(n, d)
    perm0, mask0 = shf.dense_plan(6, (d,), n, 0.3, cuda_device)
    perm = torch.empty(n * d + 1, dtype=torch.int32,
                       device=cuda_device)[1:].view(n, d)
    perm.copy_(perm0)
    mask = torch.empty(d + 1, dtype=torch.bool, device=cuda_device)[1:]
    mask.copy_(mask0)
    assert not ws.takes_vector_path(x.element_size(), d, x.data_ptr(),
                                    x.data_ptr(), perm.data_ptr(),
                                    mask.data_ptr())
    want = ref.wash_shuffle_ref(x, perm, mask)
    out = ws.wash_shuffle_cuda(x, perm, mask)
    ws.wash_shuffle_many_cuda_([x], [perm], [mask])
    torch.cuda.synchronize()
    assert _bitwise(out, want) and _bitwise(x, want)


@pytest.mark.gpu
def test_more_leaves_than_a_launch_takes(cuda_device):
    """2 x MAX_LEAVES + 5 f32 leaves: three launches, every leaf bitwise."""
    count = 2 * ws.MAX_LEAVES + 5
    widths = [64 * (1 + i % 5) + (i % 3) for i in range(count)]
    xs, perms, masks, wants = [], [], [], []
    for i, d in enumerate(widths):
        got = _grouped(cuda_device, [torch.float32], [d], 4, 100 + i)
        for acc, item in zip((xs, perms, masks, wants), got):
            acc.extend(item)
    n0 = (ws.wash_launches, ws.wash_leaves)
    ws.wash_shuffle_many_cuda_(xs, perms, masks)
    torch.cuda.synchronize()
    assert (ws.wash_launches - n0[0], ws.wash_leaves - n0[1]) == (3, count)
    assert all(_bitwise(x, w) for x, w in zip(xs, wants))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_in_place_equals_out_of_place(cuda_device, dtype):
    """The same leaf shuffled into a new tensor and where it lies (out is
    x): the same bits, and in place the unmasked columns are untouched."""
    x = _leaf(8, D, dtype, cuda_device, seed=7)
    perm, mask = _dense_plan(8, D, cuda_device, seed=8)
    before = x.clone()
    out = ws.wash_shuffle_cuda(x, perm, mask)
    torch.cuda.synchronize()
    assert _bitwise(x, before)  # out of place leaves x
    ws.wash_shuffle_many_cuda_([x], [perm], [mask])
    torch.cuda.synchronize()
    assert _bitwise(x, out)
    assert _bitwise(x[:, ~mask].contiguous(), before[:, ~mask].contiguous())


@pytest.mark.gpu
def test_dense_kernel_attributes_report_no_spill(cuda_device):
    for elt in (2, 4):
        for rows in (2, 4, 8, 16):
            attrs = ws.kernel_attributes(elt, rows)
            assert attrs["registers"] > 0 and attrs["local_bytes"] == 0, \
                (elt, rows)
            assert attrs["param_bytes"] <= 4096
