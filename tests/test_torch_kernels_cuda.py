"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA GPU (``cuda`` marker) and skips
without one. The file imports no JAX, so it runs on a machine that has
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Flash attention is held to 2e-5 in float32 and 2e-2 in bfloat16 (the
JAX suite's tolerances): the kernel and the plain version sum in other
orders, and in bf16 they round the probabilities at other points (the
kernel before normalising, the plain version after). ``ssd_chunk`` and
``lru_scan`` are held to the JAX suite's scan tolerances, 1e-4 in
float32 and 5e-2 in bfloat16."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import lru_scan as tls
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_chunk as tsc

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
    (1, 256, 256, 24, 2, 192, True, 0, 0.0),    # nemotron heads, G 12
    (1, 512, 512, 16, 1, 256, True, 128, 0.0),  # recurrentgemma heads
    (2, 1000, 1000, 8, 2, 128, True, 0, 0.0),   # Sq*G % 128 != 0, many tiles
    (1, 2048, 2048, 8, 2, 160, True, 0, 0.0),   # cycles the K/V ring
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


def flash_kernel_names(fn):
    """Names of the device kernels ``fn`` launches that hold the
    fragment ``flash_fwd_kernel``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and "flash_fwd_kernel" in e.name}


@pytest.mark.cuda
def test_flash_bf16_runs_the_tensor_core_kernel(cuda_device):
    """bf16 goes to the wgmma kernel, f32 to the CUDA-core one: one
    profiled launch of each shows two different kernels, both under
    the name fragment the serving profile books as flash."""
    shape = (1, 256, 256, 8, 2, 160)
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(shape, dtype, cuda_device, 3)
        tfa.flash_attention_cuda(q, k, v)          # built and warm
        names[dtype] = flash_kernel_names(
            lambda: tfa.flash_attention_cuda(q, k, v))
    assert len(names[torch.float32]) == 1
    assert len(names[torch.bfloat16]) == 1
    assert names[torch.float32] != names[torch.bfloat16]
    assert "wgmma" in next(iter(names[torch.bfloat16]))
    assert "wgmma" not in next(iter(names[torch.float32]))


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


SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# (B, L, H, P, N, broadcast): the JAX suite's shapes, ragged chunks and
# odd widths, Bm/Cm expanded from one group (stride 0 across heads)
SSD_SHAPES = [
    (2, 256, 2, 64, 32, False), (1, 512, 4, 64, 128, False),
    (2, 128, 2, 32, 16, False), (2, 300, 3, 24, 20, False),
    (1, 100, 2, 40, 12, True), (1, 1024, 4, 64, 64, True),
    (3, 77, 5, 256, 256, True), (1, 33, 1, 1, 1, False),
]
# (B, L, R, h0): the JAX suite's shapes and ragged ones
LRU_SHAPES = [(2, 256, 512, False), (2, 300, 130, True),
              (1, 64, 1024, True), (3, 1024, 64, False), (1, 17, 129, True),
              (2, 1, 1, False)]


def ssd_args(shape, dtype, device, seed):
    B, L, H, P, N, broadcast = shape
    rng = np.random.default_rng(seed)

    def rnd(*s, scale=0.3):
        return torch.from_numpy(rng.standard_normal(s, np.float32) * scale)

    loga = -torch.nn.functional.softplus(rnd(B, L, H, scale=1.0))
    bc = [rnd(B, L, 1 if broadcast else H, N) for _ in range(2)]
    args = [t.to(device=device, dtype=dtype)
            for t in [rnd(B, L, H, P), loga] + bc]
    if broadcast:
        args[2:] = [m.expand(B, L, H, N) for m in args[2:]]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_chunk_kernel_matches_plain(cuda_device, shape, dtype):
    args = ssd_args(shape, dtype, cuda_device, sum(shape[:5]))
    before = tops.LAUNCHES["ssd_chunk"]
    out = tsc.ssd_chunk_cuda(*args)
    plain = tsc.ssd_chunk_torch(*args)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["ssd_chunk"] == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    assert torch.isfinite(out.float()).all()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(),
                               atol=SCAN_TOL[dtype], rtol=SCAN_TOL[dtype])


@pytest.mark.cuda
def test_ssd_chunk_masks_above_the_diagonal(cuda_device):
    """Strongly decaying loga makes z_i - z_j large and positive above
    the diagonal (exp overflows there); the kernel's output stays
    finite and equals the plain version."""
    args = ssd_args((1, 256, 2, 32, 16, False), torch.float32,
                    cuda_device, 5)
    args[1] = args[1] * 40.0
    out = tsc.ssd_chunk_cuda(*args)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, tsc.ssd_chunk_torch(*args), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LRU_SHAPES)
def test_lru_scan_kernel_matches_plain(cuda_device, shape, dtype):
    B, L, R, with_h0 = shape
    rng = np.random.default_rng(L * R)
    a = torch.sigmoid(torch.from_numpy(
        rng.standard_normal((B, L, R), np.float32))).to(cuda_device, dtype)
    b = torch.from_numpy(rng.standard_normal((B, L, R), np.float32) * 0.5) \
        .to(cuda_device, dtype)
    h0 = torch.from_numpy(rng.standard_normal((B, R), np.float32)) \
        .to(cuda_device) if with_h0 else None
    before = tops.LAUNCHES["lru_scan"]
    out = tls.lru_scan_cuda(a, b, h0)
    plain = tls.lru_scan_torch(a, b, h0)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["lru_scan"] == before + 1
    assert out.dtype == dtype and out.shape == a.shape
    # the same float32 operations in the same order
    assert torch.equal(out, plain)


@pytest.mark.cuda
def test_scan_dispatch_on_card_is_the_kernel(cuda_device):
    args = ssd_args((1, 64, 2, 16, 8, True), torch.float32, cuda_device, 1)
    before = dict(tops.LAUNCHES)
    out = tops.ssd_chunk(*args)
    a = torch.rand((2, 8, 16), device=cuda_device)
    h = tops.lru_scan(a, a)
    assert tops.LAUNCHES["ssd_chunk"] == before["ssd_chunk"] + 1
    assert tops.LAUNCHES["lru_scan"] == before["lru_scan"] + 1
    assert torch.equal(out, tsc.ssd_chunk_cuda(*args))
    assert torch.equal(h, tls.lru_scan_cuda(a, a))


@pytest.mark.cuda
def test_scan_kernels_refuse_what_they_do_not_take(cuda_device):
    args = ssd_args((1, 16, 2, 8, 8, False), torch.float32, cuda_device, 2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsc.ssd_chunk_cuda(*(x.half() for x in args))
    with pytest.raises(ValueError, match="contiguous"):
        tsc.ssd_chunk_cuda(args[0].transpose(2, 3).contiguous()
                           .transpose(2, 3), *args[1:])
    with pytest.raises(ValueError, match="P=300"):
        tsc.ssd_chunk_cuda(*ssd_args((1, 16, 1, 300, 8, False),
                                     torch.float32, cuda_device, 3))
    a = torch.rand((2, 8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tls.lru_scan_cuda(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="h0"):
        tls.lru_scan_cuda(a, a, torch.zeros((2, 15), device=cuda_device))
