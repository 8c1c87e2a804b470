"""The CUDA paged-attention kernel against its plain version, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card, where neither is installed (``tests/conftest.py`` imports JAX,
hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_paged_attention_cuda.py

Without a card every test here skips.  Tolerances: 2e-5 for f32 q (f32
and int8 pools; both sides accumulate in f32, in another order) and 2e-2
for bf16 outputs (one bf16 rounding of the output).  The kernel splits
each slot's context into runs of ``pa.SPLIT_TOKENS`` tokens (8 pages of
16 here); the edge cases sit on those boundaries.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import (merge_partials_ref,
                                     paged_attention_partials_ref,
                                     paged_attention_ref)

B, H, KV, HD, PAGE, MAX_PAGES = 4, 24, 8, 128, 16, 8
LENGTHS = [1, 16, 17, 128]


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(device, P=64, seed=60):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, HD)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 2, P, PAGE, KV, HD))
                          .astype(np.float32))
    table = torch.from_numpy(rng.permutation(np.arange(1, P))[:B * MAX_PAGES]
                             .reshape(B, MAX_PAGES).astype(np.int32))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    return [t.to(device) for t in (q, kv, table, lengths)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_a_layer_view(cuda_device, dtype):
    """Pools passed as the per-layer view ``pool[1]`` of a stacked pool."""
    q, kv, table, lengths = _inputs(cuda_device)
    args = (q.to(dtype), kv[0, 1].to(dtype), kv[1, 1].to(dtype), table,
            lengths)
    n0 = pa.launches
    got = ops.paged_attention(*args)
    assert pa.launches == n0 + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), paged_attention_ref(*args).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_matches_plain_version(cuda_device, q_dtype):
    q, kv, table, lengths = _inputs(cuda_device, seed=61)
    scale = kv.abs().amax(dim=(3, 4, 5)) / 127.0                 # (2, 2, P)
    qkv = torch.round(kv / scale[..., None, None, None]).clamp(-127, 127)
    qkv = qkv.to(torch.int8)
    args = (q.to(q_dtype), qkv[0, 0], qkv[1, 0], table, lengths)
    scales = dict(k_scale=scale[0, 0].contiguous(),
                  v_scale=scale[1, 0].contiguous())
    got = ops.paged_attention(*args, **scales)
    tol = 2e-5 if q_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               paged_attention_ref(*args, **scales).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q, kv, table, lengths = _inputs(cuda_device)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention_cuda(q, kv[0, 0], kv[1, 0], table.long(), lengths)
    with pytest.raises(ValueError, match="scale"):
        pa.paged_attention_cuda(q, kv[0, 0].to(torch.int8),
                                kv[1, 0].to(torch.int8), table, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_cuda(q.transpose(0, 1).contiguous().transpose(0, 1),
                                kv[0, 0], kv[1, 0], table, lengths)


SPLIT = pa.SPLIT_TOKENS  # 128 tokens: 8 pages of 16


def _pools(device, L, P, max_pages, n_slots, hd=HD, seed=70):
    """An (L, 2, P, PAGE, KV, hd) f32 pool pair and an (n_slots, max_pages)
    table of distinct pages."""
    rng = np.random.default_rng(seed)
    kv = torch.from_numpy(rng.standard_normal((L, 2, P, PAGE, KV, hd))
                          .astype(np.float32)).to(device)
    table = torch.from_numpy(rng.permutation(np.arange(P))[:n_slots * max_pages]
                             .reshape(n_slots, max_pages).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((n_slots, H, hd))
                         .astype(np.float32))
    return q.to(device), kv, table.to(device)


def _hold(got, args, scales, tol):
    want = paged_attention_ref(*args, **scales)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    m, l, acc = paged_attention_partials_ref(*args, SPLIT, **scales)
    merged = merge_partials_ref(m, l, acc, got.dtype)
    torch.testing.assert_close(got.float(), merged.float(), rtol=tol,
                               atol=tol)


# slots' lengths on the split's edges; the longest slot alone with the
# others at 1; the table's width (13 pages) is not a multiple of a split
EDGE_LENGTHS = {
    "one": [1, 1, 1, 1],
    "split": [SPLIT, SPLIT - 1, SPLIT + 1, 2 * SPLIT],
    "longest_alone": [13 * PAGE, 1, 1, 1],
    "ragged_table": [13 * PAGE - 3, 12 * PAGE + 1, 8 * PAGE, 5],
}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8_f32q", "int8_bf16q"])
@pytest.mark.parametrize("case", list(EDGE_LENGTHS))
def test_split_edges(cuda_device, case, kind):
    max_pages = 13
    q, kv, table = _pools(cuda_device, 2, 64, max_pages, 4)
    lengths = torch.tensor(EDGE_LENGTHS[case], dtype=torch.int32,
                           device=cuda_device)
    layer = kv[1]  # (2, P, PAGE, KV, hd): a layer view of the (L, ...) pool
    scales = {}
    if kind.startswith("int8"):
        s = layer.abs().amax(dim=(2, 3, 4)) / 127.0              # (2, P)
        kq = torch.round(layer / s[:, :, None, None, None]).clamp(-127, 127)
        k_pool, v_pool = kq.to(torch.int8)
        scales = dict(k_scale=s[0].contiguous(), v_scale=s[1].contiguous())
        qd = torch.float32 if kind == "int8_f32q" else torch.bfloat16
    else:
        qd = torch.float32 if kind == "f32" else torch.bfloat16
        k_pool, v_pool = layer.to(qd)
    args = (q.to(qd), k_pool, v_pool, table, lengths)
    n0 = pa.launches
    got = ops.paged_attention(*args, **scales)
    torch.cuda.synchronize()
    assert pa.launches == n0 + 1
    assert torch.isfinite(got.float()).all()
    _hold(got, args, scales, 2e-5 if qd == torch.float32 else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_view_of_a_stacked_pool_takes_16_byte_loads(cuda_device,
                                                          dtype):
    """pool[l] of an (L, P, PAGE, KV, hd) pool: strided in P, read in
    place with the 16-byte variant."""
    q, kv, table = _pools(cuda_device, 3, 40, 9, 4, seed=71)
    pools = kv.to(dtype)[:, 0], kv.to(dtype)[:, 1]    # (L, P, PAGE, KV, hd)
    lengths = torch.tensor([9 * PAGE, 1, SPLIT + 1, 40], dtype=torch.int32,
                           device=cuda_device)
    for layer in range(3):
        args = (q.to(dtype), pools[0][layer], pools[1][layer], table, lengths)
        assert pa.load_width(args[1], args[2], H // KV) == 16 // kv.to(
            dtype).element_size()
        got = ops.paged_attention(*args)
        _hold(got, args, {}, 2e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_narrow_variant_where_16_byte_loads_do_not_fit(cuda_device, dtype):
    """hd = 96 (12 lanes a bf16 row: no power of two) and a pool whose
    head dim is not the unit-stride axis take the narrow variant."""
    rng = np.random.default_rng(72)
    for hd, transposed in ((96, False), (HD, True)):
        q, kv, table = _pools(cuda_device, 1, 48, 10, 4, hd=hd, seed=73)
        layer = kv[0]
        if transposed:  # same values, hd no longer the unit-stride axis
            layer = layer.transpose(-1, -2).contiguous().transpose(-1, -2)
        scales = {}
        if dtype == torch.int8:
            s = layer.abs().amax(dim=(2, 3, 4)) / 127.0
            qk = torch.round(layer / s[:, :, None, None, None]).clamp(-127, 127)
            k_pool, v_pool = qk.to(torch.int8)
            scales = dict(k_scale=s[0].contiguous(), v_scale=s[1].contiguous())
            qd = torch.float32
        else:
            k_pool, v_pool = layer.to(dtype)
            qd = dtype
        assert pa.load_width(k_pool, v_pool, H // KV) == 1
        lengths = torch.tensor(rng.integers(1, 10 * PAGE + 1, 4),
                               dtype=torch.int32, device=cuda_device)
        args = (q.to(qd), k_pool, v_pool, table, lengths)
        got = ops.paged_attention(*args, **scales)
        _hold(got, args, scales, 2e-5 if qd == torch.float32 else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [1, 2, 3, 8])
def test_every_group_size(cuda_device, group):
    """g = 1, 2, 3 (rounded up to 4) and 8; int8 at g = 8 loads 8 bytes."""
    kv_heads = 2
    rng = np.random.default_rng(74 + group)
    n_slots, max_pages, P = 3, 10, 40
    q = torch.from_numpy(rng.standard_normal((n_slots, group * kv_heads, HD))
                         .astype(np.float32)).to(cuda_device)
    kv = torch.from_numpy(rng.standard_normal((2, P, PAGE, kv_heads, HD))
                          .astype(np.float32)).to(cuda_device)
    table = torch.from_numpy(rng.permutation(P)[:n_slots * max_pages]
                             .reshape(n_slots, max_pages).astype(np.int32)
                             ).to(cuda_device)
    lengths = torch.tensor([1, SPLIT + 1, max_pages * PAGE], dtype=torch.int32,
                           device=cuda_device)
    s = kv.abs().amax(dim=(2, 3, 4)) / 127.0
    qk = torch.round(kv / s[:, :, None, None, None]).clamp(-127, 127)
    for pools, scales, qd in (
            ((kv[0].bfloat16(), kv[1].bfloat16()), {}, torch.bfloat16),
            (tuple(qk.to(torch.int8)), dict(k_scale=s[0].contiguous(),
                                            v_scale=s[1].contiguous()),
             torch.float32)):
        args = (q.to(qd), pools[0], pools[1], table, lengths)
        got = ops.paged_attention(*args, **scales)
        _hold(got, args, scales, 2e-5 if qd == torch.float32 else 2e-2)
