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
float32 and 5e-2 in bfloat16 (``ssd_chunk`` runs its products as
3xTF32 on the tensor cores: another order of sums and a residual of
about 2^-21 of an operand). ``schedule_step`` is bit-equal to its plain
version on all 8 fields."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import lru_scan as tls
from repro_torch.kernels import ops as tops
from repro_torch.kernels import schedule_step as tss
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


_PROFILE_ONE_CALL = """
import json, sys
sys.path[:0] = {paths!r}
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from test_torch_kernels_cuda import *
dev = torch.device("cuda")
{setup}
fn()                                  # built and warm
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]))
"""


def device_kernels(setup):
    """Names of the device kernels that one call of ``fn`` launches, one
    entry a launch, from ``torch.profiler`` in a fresh process: a second
    profiling session in one process can miss a single short kernel's
    device record. ``setup`` is Python source that defines ``fn`` (this
    module's names and ``dev`` are in scope)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _PROFILE_ONE_CALL.format(
        paths=[os.path.join(root, "src"), os.path.join(root, "tests")],
        setup=setup)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def flash_kernel_names(setup):
    """Names of the device kernels one call of ``fn`` (defined by
    ``setup``) launches that hold the fragment ``flash_fwd_kernel``."""
    return {n for n in device_kernels(setup) if "flash_fwd_kernel" in n}


@pytest.mark.cuda
def test_flash_bf16_runs_the_tensor_core_kernel(cuda_device):
    """bf16 goes to the wgmma kernel, f32 to the CUDA-core one: one
    profiled launch of each shows two different kernels, both under
    the name fragment the serving profile books as flash."""
    shape = (1, 256, 256, 8, 2, 160)
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        names[dtype] = flash_kernel_names(
            f"q, k, v = qkv({shape}, {dtype}, dev, 3)\n"
            "fn = lambda: tfa.flash_attention_cuda(q, k, v)")
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_runs_the_tensor_core_kernel(cuda_device, dtype):
    """One ssd_chunk_cuda call is one launch of the wgmma (3xTF32)
    kernel, under the name fragment the serving profile books as
    ssd_chunk."""
    names = device_kernels(
        f"args = ssd_args((2, 512, 4, 64, 128, True), {dtype}, dev, 4)\n"
        "fn = lambda: tsc.ssd_chunk_cuda(*args)")
    assert len(names) == 1
    assert "ssd_chunk_kernel_wgmma" in names[0]


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


# schedule_step: chip_smoke.py's KERNEL_SHAPES (B, J, M), then odd node
# counts and ragged tiles (the kernel's unaligned-slab and scalar-store
# paths), then more nodes than the 640 the kernel stages at a time:
# up to 7680, and beyond (8192, 20000 and 12345, which is no multiple
# of 640, so its last node range is ragged)
SCHED_SHAPES = [(b, j, m) for b in (1, 4) for j in (5, 1000, 65536)
                for m in (8, 84)] + [(3, 777, 13), (2, 300, 33)] \
    + [(2, 300, 641), (1, 513, 1283), (1, 1000, 7680), (1, 1024, 8192),
       (1, 512, 20000), (2, 300, 12345)]


def sched_args(B, J, M, device, seed, empty=False):
    """Stacked (B, ...) schedule_step arguments on the card, drawn with
    numpy like the JAX suite's integer tiles (single and 2-node gang
    assignments, mixed masks, random queue keys); normalizers and s
    per batch row."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    node = rng.integers(0, M, (B, J))
    gang = rng.random((B, J)) < 0.3
    assign = np.zeros((B, J, M), bool)
    bi, ji = np.meshgrid(np.arange(B), np.arange(J), indexing="ij")
    assign[bi, ji, node] = True
    assign[bi[gang], ji[gang], (node[gang] + 1) % M] = True
    arrays = dict(
        demand=np.stack([rng.integers(1, 33, (B, J)),
                         rng.integers(1, 257, (B, J)),
                         rng.integers(0, 9, (B, J))], -1).astype(f32),
        gp=rng.integers(0, 21, (B, J)).astype(f32),
        width=np.where(gang, 2, 1).astype(np.int32),
        queue_key=(rng.random((B, J)) * 100.0).astype(f32),
        assign=assign,
        free=np.stack([rng.integers(0, 16, (B, M)),
                       rng.integers(0, 128, (B, M)),
                       rng.integers(0, 5, (B, M))], -1).astype(f32),
        pending_free=np.stack([rng.integers(0, 8, (B, M)),
                               rng.integers(0, 64, (B, M)),
                               rng.integers(0, 3, (B, M))], -1).astype(f32),
        cand=rng.random((B, J)) < 0.7, under=rng.random((B, J)) < 0.9,
        be_q=rng.random((B, J)) < 0.4,
        te_demand=np.tile(np.array([4.0, 16.0, 4.0], f32), (B, 1)),
        node_cap=np.tile(np.array([32.0, 256.0, 8.0], f32), (B, 1)))
    if empty:
        for k in ("cand", "under", "be_q"):
            arrays[k][:] = False
    args = [torch.from_numpy(a).to(device) for a in arrays.values()]
    norms = [tops.normalizers(args[0][b], args[1][b], args[7][b],
                              args[11][b]) for b in range(B)]
    return args + [torch.stack([n[0] for n in norms]),
                   torch.stack([n[1] for n in norms]),
                   torch.full((B,), 4.0, device=device)]


def assert_pass_equal(args):
    """One kernel call bit-equal to the plain version on all 8 fields,
    counted as one launch."""
    before = tops.LAUNCHES["schedule_step"]
    got = tss.schedule_step_cuda(*args)
    want = tss.schedule_step_torch(*args)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["schedule_step"] == before + 1
    for name, x, y in zip(tss.SchedulePass._fields, got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCHED_SHAPES)
def test_schedule_step_kernel_matches_plain(cuda_device, shape):
    assert_pass_equal(sched_args(*shape, cuda_device, seed=sum(shape)))


@pytest.mark.cuda
def test_schedule_step_empty_masks_give_sentinels(cuda_device):
    got = assert_pass_equal(sched_args(2, 1000, 84, cuda_device, seed=7,
                                       empty=True))
    for name in ("victim", "be_head", "be_pick"):
        assert (getattr(got, name) == -1).all(), name
    assert (got.nskip == 0).all()


@pytest.mark.cuda
def test_schedule_step_beyond_one_resident_wave(cuda_device):
    """2^20 jobs are 4,096 tiles, more than the cooperative grid's
    resident blocks, so each block walks several tiles (and keeps the
    late keys of the first few only)."""
    assert_pass_equal(sched_args(1, 2 ** 20, 84, cuda_device, seed=11))


@pytest.mark.cuda
def test_schedule_step_gang_score_pass(cuda_device):
    """A pass built like fitgpp's gang-score pass at the gang workload's
    shape (2^15 jobs, 84 nodes): widths 1, 2, 4 and 8 on as many
    consecutive nodes, each job's total demand (demand * width), live
    cand and under masks, no BE queue, a zero TE demand."""
    J, M = 2 ** 15, 84
    args = sched_args(1, J, M, cuda_device, seed=15)
    rng = np.random.default_rng(16)
    width = rng.choice(np.array([1, 2, 4, 8], np.int32), J)
    cols = (rng.integers(0, M, J)[:, None] + np.arange(8)) % M
    keep = np.arange(8) < width[:, None]
    assign = np.zeros((J, M), bool)
    assign[np.nonzero(keep)[0], cols[keep]] = True
    args[2] = torch.from_numpy(width[None]).to(cuda_device)
    args[4] = torch.from_numpy(assign[None]).to(cuda_device)
    args[0] = args[0] * args[2][..., None].float()
    args[9] = torch.zeros_like(args[9])
    args[10] = torch.zeros_like(args[10])
    args[12], args[13] = (x[None] for x in tops.normalizers(
        args[0][0], args[1][0], args[7][0], args[11][0]))
    got = assert_pass_equal(args)
    assert (got.victim >= 0).all() and (got.be_head == -1).all()


@pytest.mark.cuda
def test_schedule_step_is_one_kernel_a_call(cuda_device):
    for B in (1, 4):
        names = device_kernels(
            f"args = sched_args({B}, 65536, 84, dev, seed={B})\n"
            "fn = lambda: tss.schedule_step_cuda(*args)")
        assert len(names) == 1, names
        assert "schedule_step_kernel" in names[0]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fitgpp", "srtp"])
def test_gang_backfill_engine_kernel_path_equals_plain_path(cuda_device,
                                                            monkeypatch,
                                                            policy):
    """gang-heavy with backfill on 16 nodes (gangs preempt, fitgpp's
    gang scores come from the kernel's pass): the whole final State of
    the kernel path equals the plain path's, generator included."""
    from repro_torch import api, scenarios
    from repro_torch.core import sim_torch
    cfg = api.make_config(policy, n_jobs=192, n_nodes=16, seed=0, P=4,
                          backfill=True)
    jobs = sim_torch.jobs_from_jobset(scenarios.build("gang-heavy", cfg),
                                      cuda_device)
    before = tops.LAUNCHES["schedule_step"]
    kern = sim_torch.state_to_numpy(sim_torch.run(cfg, jobs, 0))
    assert tops.LAUNCHES["schedule_step"] > before
    assert kern["preempt_count"].sum() > 0
    monkeypatch.setattr(tops, "_FORCE_PLAIN", True)
    plain = sim_torch.state_to_numpy(sim_torch.run(cfg, jobs, 0))
    assert sim_torch.state_diff_fields(kern, plain) == []


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["event", "tick"])
def test_batched_engine_kernel_path_equals_plain_path(cuda_device, mode):
    """A 4-trial burst-storm table (8 nodes, 64 jobs, s in {0, 4}) through
    the batched engine: the kernel path's State equals the plain path's
    on the card on every field (draw counts included), and the card's
    counter-based draws equal the CPU's."""
    import dataclasses

    from repro_torch import api, scenarios
    from repro_torch.core import sim_batch, sweep_fabric
    cfg = api.make_config("fitgpp", n_jobs=64, n_nodes=8, seed=0)
    jobsets = [scenarios.build("burst-storm", dataclasses.replace(cfg, seed=k))
               for k in range(2)]
    table = sweep_fabric.build_table(jobsets * 2, np.float32([0, 0, 4, 4]), 1,
                                     np.uint32([0, 1, 0, 1]))
    jobs = table.jobs.map(lambda x: x.to(cuda_device))
    states = []
    for force in (False, True):
        tops._FORCE_PLAIN = force
        try:
            before = tops.LAUNCHES["schedule_step"]
            st = sim_batch.run(cfg, jobs, table.s, table.P, table.seed,
                               time_mode=mode)
            launched = tops.LAUNCHES["schedule_step"] - before
        finally:
            tops._FORCE_PLAIN = False
        assert (launched > 0) != force
        states.append(sim_batch.state_to_numpy(st))
    for k in states[0]:
        np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)
    assert (states[0]["n_done"] == states[0]["state"].shape[1]).all()
    seed = torch.tensor([0, 7, 123456789], dtype=torch.int64)
    count = torch.tensor([0, 3, 2 ** 33], dtype=torch.int64)
    torch.testing.assert_close(
        sim_batch.uniforms(seed.to(cuda_device), count.to(cuda_device),
                           1000).cpu(),
        sim_batch.uniforms(seed, count, 1000), rtol=0, atol=0)


def tie_args(J, M, device, seed):
    """A one-row pass with many tied Eq. 3 scores (two demand rows, two
    grace periods), free capacity that keeps most candidates Eq. 2
    eligible, live cand and under masks, and ``akey`` a seeded
    permutation, as the stream engine's pool passes it."""
    args = sched_args(1, J, M, device, seed)
    rng = np.random.default_rng(seed + 500)
    rows = np.array([[4.0, 16.0, 1.0], [8.0, 32.0, 2.0]], np.float32)
    args[0] = torch.from_numpy(rows[rng.integers(0, 2, J)][None]).to(device)
    args[1] = torch.from_numpy(rng.choice(np.array([0.0, 4.0], np.float32),
                                          J)[None]).to(device)
    args[5] = torch.tensor([[[8.0, 64.0, 4.0]]], device=device) \
        .expand(1, M, 3).contiguous()
    args[12], args[13] = (x[None] for x in tops.normalizers(
        args[0][0], args[1][0], args[7][0], args[11][0]))
    akey = torch.from_numpy(rng.permutation(J).astype(np.float32)[None])
    return args, akey.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("J", [2688, 65536])
def test_schedule_step_akey_kernel_matches_plain(cuda_device, J):
    """With ``akey`` the kernel's victim is the plain version's (score,
    akey, index) minimum, bit for bit with every other field; the tie
    changes the victim from the one without ``akey``."""
    args, akey = tie_args(J, 84, cuda_device, seed=J)
    got = assert_pass_equal(args + [akey])
    assert int(got.victim) != int(assert_pass_equal(args).victim)


@pytest.mark.cuda
def test_stream_engine_card_equals_cpu(cuda_device):
    """The stream engine on the card (the kernel, with ``akey``) gives
    the CPU plain path's per-job results and events."""
    import dataclasses
    from repro_torch import api
    from repro_torch.core import stream, workload
    cfg = api.make_config("fitgpp", n_jobs=400, n_nodes=8, seed=0)
    cfg = dataclasses.replace(cfg, workload=dataclasses.replace(
        cfg.workload, load=0.5))
    out = {}
    for dev in ("cpu", cuda_device):
        before = tops.LAUNCHES["schedule_step"]
        src = stream.JobSource(workload.stream_chunks(cfg, 400, chunk=64))
        out[str(dev)] = stream.StreamEngine(cfg, src, capacity=96,
                                            trace=True, device=dev).run()
        launched = tops.LAUNCHES["schedule_step"] - before
        assert (launched > 0) == (str(dev) != "cpu")
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert cpu.rounds > 1 and card.fallback_count == cpu.fallback_count == 0
    for f in ("finish", "preempt_count", "last_signal", "last_vacate",
              "last_resume"):
        assert np.array_equal(getattr(card, f), getattr(cpu, f)), f
    assert card.events == cpu.events and card.makespan == cpu.makespan


@pytest.mark.cuda
def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda_device):
    """The three model kernels have no backward: on an input that
    requires grad, with grad mode on, each wrapper raises rather than
    return a tensor without ``grad_fn``; under ``no_grad`` it launches."""
    q, k, v = qkv((1, 128, 128, 4, 2, 32), torch.float32, cuda_device, 4)
    ssd = ssd_args((1, 64, 2, 16, 8, True), torch.float32, cuda_device, 5)
    a = torch.rand((2, 8, 16), device=cuda_device)
    calls = {"flash_attention": (tops.flash_attention, (q, k, v)),
             "ssd_chunk": (tops.ssd_chunk, ssd),
             "lru_scan": (tops.lru_scan, (a, a))}
    for name, (fn, args) in calls.items():
        before = tops.LAUNCHES[name]
        leaf = args[0].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name} kernel has no "
                           "backward"):
            fn(leaf, *args[1:])
        assert tops.LAUNCHES[name] == before
        with torch.no_grad():
            fn(leaf, *args[1:])
        assert tops.LAUNCHES[name] == before + 1


def _smoke_train_steps(device, n=2):
    """``n`` float32 train steps of the dense smoke config from seed 0 on
    ``device``: (losses, parameters after the steps as CPU tensors)."""
    from repro_torch import trainer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_smoke_config("stablelm-12b").replace(dtype="float32")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    model = trainer.init_train_state(cfg, ocfg, 0, device="cpu")["params"]
    model = model.to(device)
    state = {"params": model, "opt": adamw_init(model, ocfg)}
    step, losses = trainer.make_train_step(cfg, ocfg), []
    for i in range(n):
        batch = make_batch(cfg, 4, 64, 0, i, device="cpu")
        state, m = step(state, {"tokens": batch["tokens"].to(device)})
        losses.append(float(m["loss"]))
    return losses, {k: p.detach().cpu() for k, p in
                    state["params"].named_parameters()}


@pytest.mark.cuda
def test_dense_train_step_repeats_on_card_and_matches_cpu(cuda_device):
    """Two dense smoke train steps on the card launch no kernel (attention
    takes its plain path), repeat bit for bit, and agree with the CPU's
    within 1e-4: each loss relative, each parameter leaf of its norm
    (elementwise, AdamW's g / (sqrt(v) + eps) magnifies the f32
    disagreement of a gradient entry near zero up to the learning rate)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = dict(tops.LAUNCHES)
        loss1, p1 = _smoke_train_steps(cuda_device)
        loss2, p2 = _smoke_train_steps(cuda_device)
        assert dict(tops.LAUNCHES) == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert loss1 == loss2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    loss_cpu, p_cpu = _smoke_train_steps("cpu")
    for a, b in zip(loss1, loss_cpu):
        assert abs(a - b) <= 1e-4 * abs(b), (loss1, loss_cpu)
    for k in p1:
        err = float((p1[k] - p_cpu[k]).norm() / p_cpu[k].norm())
        assert err <= 1e-4, (k, err)
