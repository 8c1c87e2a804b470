"""The port's WASH-shuffle routes on the CPU against the JAX package.

The plain versions behind ``repro_torch.kernels.ops.wash_shuffle`` and
``bucketed_shuffle`` (what the CPU runs and what ``chip_smoke.py`` holds
the CUDA kernels to) against JAX's Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them), JAX's ``ref.wash_shuffle_ref`` and
``core.shuffle.bucketed_apply_stacked``.  Tolerance: none, the shuffle is
pure data movement, so results are compared bit for bit in float32 and
bfloat16.  Inputs come from numpy with a seed; bucketed plans are built by
JAX and cross as arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shuffle as jshf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wash_shuffle as ws
from repro_torch.train.interop import tensor_from_numpy, tensor_to_numpy

D = 1037  # not a multiple of any block size
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _bits(a) -> np.ndarray:
    """Raw bits of a float32 or bfloat16 array (JAX or torch)."""
    if isinstance(a, torch.Tensor):
        a = tensor_to_numpy(a)
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _dense_inputs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((n, D)).astype(np.float32), dtype)
    perm = np.argsort(rng.random((n, D)), axis=0).astype(np.int32)
    mask = rng.random(D) < 0.4
    return x, perm, mask


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_plain_wash_shuffle_matches_jax_kernel_bitwise(n, dtype):
    x, perm, mask = _dense_inputs(n, DTYPES[dtype], seed=n)
    want = jops.wash_shuffle(x, jnp.asarray(perm), jnp.asarray(mask),
                             block_d=256)
    tx = tensor_from_numpy(np.asarray(x), "cpu")
    got = ops.wash_shuffle(tx, torch.from_numpy(perm), torch.from_numpy(mask))
    assert got.dtype == tx.dtype and got.shape == (n, D)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(jref.wash_shuffle_ref(x, jnp.asarray(perm),
                                                jnp.asarray(mask))))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_plain_bucketed_shuffle_matches_jax_bitwise(n, dtype):
    rng = np.random.default_rng(10 + n)
    x = jnp.asarray(rng.standard_normal((n, D)).astype(np.float32),
                    DTYPES[dtype])
    idx = jshf.bucketed_plan(jax.random.key(n), D, n, 0.6)
    want = jops.bucketed_shuffle(x, idx, block_d=256)
    np.testing.assert_array_equal(
        _bits(want), _bits(jshf.bucketed_apply_stacked(x, idx)))

    tx = tensor_from_numpy(np.asarray(x), "cpu")
    before = tx.clone()
    tidx = torch.from_numpy(np.array(idx))
    got = ops.bucketed_shuffle(tx, tidx)  # functional: tx untouched
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(tx), _bits(before))
    same = ops.bucketed_shuffle_(tx, tidx)  # in place
    assert same is tx
    np.testing.assert_array_equal(_bits(tx), _bits(want))


def test_bucket_zero_and_unplanned_columns_stay():
    n = 4
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    idx = torch.from_numpy(np.array(
        jshf.bucketed_plan(jax.random.key(5), D, n, 0.3)))
    out = ref.bucketed_shuffle_ref(x, idx)
    moved = idx[1:].reshape(-1).long()
    still = torch.ones(D, dtype=torch.bool)
    still[moved] = False
    assert torch.equal(out[:, still], x[:, still])
    for s in range(1, n):
        assert torch.equal(out[:, idx[s].long()],
                           torch.roll(x[:, idx[s].long()], -s, dims=0))


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route reached the CUDA kernel")

    for name in ("build", "wash_shuffle_cuda", "bucketed_shuffle_cuda_"):
        monkeypatch.setattr(ws, name, refuse)
    counts = (ws.wash_launches, ws.bucketed_launches)
    x, perm, mask = _dense_inputs(3, jnp.float32, seed=1)
    tx = torch.from_numpy(np.array(x))
    ops.wash_shuffle(tx, torch.from_numpy(perm), torch.from_numpy(mask))
    ops.bucketed_shuffle_(tx, torch.tensor([[0], [5], [9]], dtype=torch.int32))
    assert (ws.wash_launches, ws.bucketed_launches) == counts
    assert ws._lib is None


def test_cuda_wrappers_refuse_cpu_tensors_before_building(monkeypatch):
    monkeypatch.setattr(ws, "build", lambda: pytest.fail("built"))
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ws.wash_shuffle_cuda(x, torch.zeros(2, 8, dtype=torch.int32),
                             torch.zeros(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        ws.bucketed_shuffle_cuda_(x, torch.zeros(2, 1, dtype=torch.int32))


def test_routes_refuse_other_devices():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="no route"):
        ops.wash_shuffle(x, x.int(), x[0].bool())
    with pytest.raises(ValueError, match="no route"):
        ops.bucketed_shuffle_(x, torch.empty(2, 1, dtype=torch.int32,
                                             device="meta"))
