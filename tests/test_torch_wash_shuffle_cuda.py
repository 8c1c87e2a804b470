"""The CUDA WASH-shuffle kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card, where neither is installed (``tests/conftest.py`` imports JAX,
hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_wash_shuffle_cuda.py

Without a card every test here skips.  Tolerance: none.  Both kernels are
pure data movement, so their results are compared bit for bit with the
plain versions (float32, bfloat16, float16), including a leaf of more
than 2**31 elements, where 32-bit offsets would wrap.
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
    counts = (ws.wash_launches, ws.bucketed_launches)
    shf.apply_plan_stacked(plan, tree, mode)
    shf.apply_plan_stacked(cpu_plan, cpu_tree, mode)
    launched = (ws.wash_launches - counts[0], ws.bucketed_launches - counts[1])
    assert launched == ((2, 0) if mode == "dense" else (0, 2))
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
