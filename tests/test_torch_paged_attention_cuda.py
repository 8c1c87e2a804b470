"""The CUDA paged-attention kernel against its plain version, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card, where neither is installed (``tests/conftest.py`` imports JAX,
hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_paged_attention_cuda.py

Without a card every test here skips.  Tolerances: 2e-5 for f32 q (f32
and int8 pools; both sides accumulate in f32, in another order) and 2e-2
for bf16 outputs (one bf16 rounding of the output).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import paged_attention_ref

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
