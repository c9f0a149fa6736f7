"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA GPU (``cuda`` marker) and skips
without one. The file imports no JAX, so it runs on a machine that has
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Flash attention is held to 2e-5 in float32 and 2e-2 in bfloat16 (the
JAX suite's tolerances): the kernel and the plain version sum in other
orders, and in bf16 they round the probabilities at other points (the
kernel before normalising, the plain version after)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

# (B, Sq, Skv, H, KV, hd, causal, window, softcap)
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 128, 256, 4, 1, 128, True, 0, 0.0),     # offset queries
    (2, 256, 256, 8, 8, 64, True, 64, 0.0),     # MHA + window
    (1, 256, 256, 2, 1, 64, False, 0, 0.0),     # bidirectional
    (1, 128, 128, 4, 2, 64, True, 0, 30.0),     # softcap
    (2, 300, 300, 4, 2, 64, True, 0, 0.0),      # ragged
    (1, 100, 260, 4, 4, 32, True, 48, 0.0),     # ragged + window
    (1, 256, 256, 32, 8, 160, True, 0, 0.0),    # stablelm heads
    (2, 77, 77, 12, 1, 8, True, 0, 0.0),        # MQA, G 12, hd 8
    (1, 64, 200, 8, 2, 256, True, 33, 5.0),     # hd 256, window, softcap
    (2, 65, 65, 6, 2, 136, True, 0, 0.0),       # hd 136, ragged edges
    (1, 40, 40, 2, 1, 16, False, 8, 0.0),       # window without causal
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def qkv(shape, dtype, device, seed):
    B, Sq, Skv, H, KV, hd = shape[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to(device=device, dtype=dtype)
            for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda_device, shape, dtype):
    causal, window, cap = shape[6:]
    q, k, v = qkv(shape, dtype, cuda_device, sum(shape[:6]))
    before = tops.LAUNCHES["flash_attention"]
    out = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   softcap=cap)
    plain = tfa.flash_attention_torch(q, k, v, causal=causal, window=window,
                                      softcap=cap)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_flash_dispatch_on_card_is_the_kernel(cuda_device):
    q, k, v = qkv((1, 128, 128, 4, 2, 32), torch.float32, cuda_device, 1)
    before = tops.LAUNCHES["flash_attention"]
    out = tops.flash_attention(q, k, v, causal=True)
    assert tops.LAUNCHES["flash_attention"] == before + 1
    assert torch.equal(out, tfa.flash_attention_cuda(q, k, v, causal=True))


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = qkv((1, 16, 16, 2, 1, 12), torch.float32, cuda_device, 2)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_cuda(q, k, v)
    q, k, v = qkv((1, 16, 16, 2, 1, 16), torch.float16, cuda_device, 2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention_cuda(q, k, v)
    q, k, v = qkv((1, 16, 16, 2, 1, 16), torch.float32, cuda_device, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_cuda(q.transpose(1, 2), k, v)
