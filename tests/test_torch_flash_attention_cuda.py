"""The CUDA flash-attention kernel against its plain version, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_flash_attention_cuda.py

Without a card every test here skips.  Tolerances: 2e-5 in f32 (both
sides accumulate in f32, in another order; the kernel's products are
3xTF32, float32-accurate) and 2e-2 in bf16 (the tensor-core kernel
rounds P to bf16 for P V, and the output once), the
``tests/test_kernels.py`` bounds.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(device, B, S, H, KV, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return [torch.from_numpy(a).to(device).to(dtype) for a in (q, k, v)]


CASES = [
    # B, S, H, KV, hd, causal, window
    (1, 64, 4, 4, 32, True, None),     # MHA, one tile
    (2, 128, 4, 2, 64, True, None),    # GQA
    (1, 96, 8, 1, 128, True, None),    # MQA, ragged last tile
    (2, 200, 6, 2, 128, True, 37),     # window inside a tile, ragged
    (1, 257, 4, 2, 64, True, 64),      # window of one tile, S = 4 tiles + 1
    (2, 100, 4, 2, 32, False, None),   # non-causal, ragged
    (1, 130, 4, 4, 64, False, 20),     # non-causal with a window
    (1, 1, 4, 2, 128, True, None),     # a single token
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", CASES)
def test_kernel_matches_plain_version(cuda_device, dtype, B, S, H, KV, hd,
                                      causal, window):
    q, k, v = _inputs(cuda_device, B, S, H, KV, hd, dtype, seed=S + hd)
    n0 = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_f32_kernel_at_the_llama_prefill_row(cuda_device):
    """The 3xTF32 kernel at llama3.2-3b's prefill row (S=2048, 24 heads
    over 8, hd 128, causal; one batch row): the float32 bound 2e-5."""
    q, k, v = _inputs(cuda_device, 1, 2048, 24, 8, 128, torch.float32,
                      seed=2048)
    got = ops.flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    q, k, v = _inputs(cuda_device, 1, 16, 4, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _inputs(cuda_device, 1, 16, 4, 3, 64, torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v)
    q, k, v = _inputs(cuda_device, 1, 16, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q.half(), k.half(), v.half())


# the bf16 tensor-core kernel's edges: S below, at and past 64 rows (one
# consumer warpgroup's) and 128 (a block's q tile and a key tile), each
# head dim (hd 32 uses the 64-byte swizzle, hd 128 two 64-column TMA
# boxes), group sizes 1, 3 and 8
EDGE_S = [1, 63, 64, 65, 127, 128, 129, 1000, 2048]
EDGE_HEADS = [(2, 2), (6, 2), (8, 1)]  # (H, KV): g = 1, 3, 8


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("H,KV", EDGE_HEADS, ids=["g1", "g3", "g8"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", EDGE_S)
def test_bf16_kernel_edges(cuda_device, S, hd, H, KV, causal):
    q, k, v = _inputs(cuda_device, 1, S, H, KV, hd, torch.bfloat16,
                      seed=S * 7 + hd + H)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("window", [17, 200])  # inside one tile; > a q tile
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", [65, 1000, 2048])
def test_bf16_kernel_windows(cuda_device, S, hd, window, causal):
    q, k, v = _inputs(cuda_device, 2, S, 6, 2, hd, torch.bfloat16,
                      seed=S + hd + window)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
def test_bf16_wrapper_refuses_a_misaligned_view(cuda_device):
    q, k, v = _inputs(cuda_device, 1, 16, 4, 2, 64, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    shifted = flat[1:].view(q.shape)  # contiguous, 2 bytes off 16
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(shifted, k, v)


@pytest.mark.gpu
def test_f32_wrapper_refuses_a_misaligned_view(cuda_device):
    """The f32 kernel copies 16-byte pieces with cp.async, so it takes
    16-byte aligned tensors only, as the bf16 one (TMA) does."""
    q, k, v = _inputs(cuda_device, 1, 16, 4, 2, 64, torch.float32)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    shifted = flat[1:].view(q.shape)  # contiguous, 4 bytes off 16
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(shifted, k, v)


# MLA's widths, (192, 128): q and k 192 wide (three 64-column TMA boxes in
# bf16), v and the output 128 wide; the bf16 output staged in Q's room, the
# f32 block of four warps (64 query rows)
MLA_CASES = [
    # B, S, H, KV, causal
    (1, 1, 2, 2, True),
    (1, 63, 2, 2, True),
    (2, 129, 4, 4, True),   # ragged past a q tile and a key tile
    (1, 300, 4, 1, True),   # GQA, several key tiles
    (1, 200, 2, 2, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,causal", MLA_CASES)
def test_mla_widths_match_plain_version(cuda_device, dtype, B, S, H, KV,
                                        causal):
    q, k, _ = _inputs(cuda_device, B, S, H, KV, 192, dtype, seed=S + H)
    v = _inputs(cuda_device, B, S, H, KV, 128, dtype, seed=S + 1)[2]
    n0 = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (B, S, H, 128)
    assert torch.isfinite(got.float()).all()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_wrapper_refuses_an_unported_width_pair(cuda_device):
    q, k, _ = _inputs(cuda_device, 1, 16, 2, 2, 192, torch.bfloat16)
    v = _inputs(cuda_device, 1, 16, 2, 2, 64, torch.bfloat16)[2]
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, k, v)
