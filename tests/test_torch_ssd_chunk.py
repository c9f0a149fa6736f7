"""The port's ``ssd_chunk`` against the JAX package.

The plain PyTorch version ``ssd_chunk_torch`` (and ``ops.ssd_chunk``,
which runs it for CPU tensors) is held against the Pallas kernel
(``repro.kernels.ops.ssd_chunk``, interpret mode on the CPU, as
``tests/test_kernels.py::TestSsdChunkKernel`` runs it), the
``ref.ssd_chunk_ref`` oracle chunk by chunk, and the ``y_diag`` term of
``models.ssm.ssd_scan``, at the JAX suite's shapes in float32
(tolerance 1e-4) and bfloat16 (5e-2, the JAX suite's scan tolerances:
both sides compute in float32 and round the output once, so they
differ by the order of their sums, and in bf16 by a rounding step).
Inputs are drawn with numpy and rounded to the working type the same
way on both sides. The CUDA kernel is held against the plain version on
the card in ``tests/test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_chunk as tsc

# (B, L, H, P, N): tests/test_kernels.py::TestSsdChunkKernel
SHAPES = [(2, 256, 2, 64, 32), (1, 512, 4, 64, 128), (2, 128, 2, 32, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def make_inputs(B, L, H, P, N, seed):
    """xdt, loga, Bm, Cm as the JAX suite draws them (0.3 * normal and
    -softplus(normal)), from numpy."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, L, H, P), np.float32) * 0.3
    loga = -np.logaddexp(rng.standard_normal((B, L, H), np.float32), 0.0)
    Bm = rng.standard_normal((B, L, H, N), np.float32) * 0.3
    Cm = rng.standard_normal((B, L, H, N), np.float32) * 0.3
    return xdt, loga.astype(np.float32), Bm, Cm


def both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def oracle_by_chunks(j_args, Q):
    L = j_args[0].shape[1]
    return jnp.concatenate(
        [jref.ssd_chunk_ref(*(a[:, c:c + Q] for a in j_args))
         for c in range(0, L, Q)], axis=1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_and_oracle(shape, dtype):
    j_args, t_args = both(make_inputs(*shape, seed=sum(shape)), dtype)
    tol = DTYPES[dtype][2]
    got = tsc.ssd_chunk_torch(*t_args)
    assert got.dtype == t_args[0].dtype and got.shape == t_args[0].shape
    pallas = jops.ssd_chunk(*j_args)
    oracle = oracle_by_chunks(j_args, min(256, shape[1]))
    for want in (pallas, oracle):
        np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    np.testing.assert_array_equal(f32(tops.ssd_chunk(*t_args)), f32(got))


@pytest.mark.parametrize("L", [300, 100])
def test_ragged_last_chunk_matches_oracle(L):
    """The port takes a shorter last chunk (the JAX wrapper asserts L is
    a multiple of Q = min(256, L)): chunks of 256 then 44, or one
    chunk of 100, each the oracle's."""
    j_args, t_args = both(make_inputs(2, L, 3, 24, 20, seed=L), "float32")
    np.testing.assert_allclose(f32(tsc.ssd_chunk_torch(*t_args)),
                               f32(oracle_by_chunks(j_args, 256)),
                               atol=1e-4, rtol=1e-4)


def test_matches_ssd_scan_y_diag():
    """With zero initial state and one chunk, ssd_scan's output is its
    y_diag term alone (tests/test_kernels.py's case)."""
    xdt, loga, Bm, Cm = make_inputs(1, 64, 2, 16, 8, seed=9)
    y_scan, _ = jssm.ssd_scan(*(jnp.asarray(a) for a in (xdt, loga, Bm, Cm)),
                              chunk=64)
    got = tsc.ssd_chunk_torch(*(torch.from_numpy(a)
                                for a in (xdt, loga, Bm, Cm)))
    np.testing.assert_allclose(f32(got), f32(y_scan), atol=1e-4, rtol=1e-4)


def test_heads_broadcast_from_one_group():
    """Bm/Cm as an expanded view (stride 0 across heads), as ssd_scan
    passes them, give what the materialised copy gives."""
    xdt, loga, Bm, Cm = (torch.from_numpy(a) for a in
                         make_inputs(2, 96, 4, 16, 8, seed=3))
    b1, c1 = Bm[:, :, :1], Cm[:, :, :1]
    view = tsc.ssd_chunk_torch(xdt, loga, b1.expand(-1, -1, 4, -1),
                               c1.expand(-1, -1, 4, -1))
    copy = tsc.ssd_chunk_torch(xdt, loga, b1.repeat(1, 1, 4, 1),
                               c1.repeat(1, 1, 4, 1))
    assert torch.equal(view, copy)


def test_cpu_path_launches_no_kernel_and_wrapper_refuses_cpu():
    args = [torch.from_numpy(a) for a in make_inputs(1, 64, 2, 16, 8, 1)]
    before = dict(tops.LAUNCHES)
    tops.ssd_chunk(*args)
    assert tops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tsc.ssd_chunk_cuda(*args)


# ---- why the CUDA kernel is held to 1e-4 and not bit for bit ----
# The kernel (csrc/ssd_chunk.cu) runs both products on the tensor cores
# as 3xTF32: v = hi + lo with hi = tf32(v), lo = tf32(v - hi), and
# a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi. The card's TF32 rounding
# (cvt.rna: to 10 mantissa bits, ties away from zero) is emulated here
# on float32 bit patterns.

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, ties away from zero),
    as cvt.rna.tf32.f32 rounds it; finite inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def chunk_decay(loga):
    """Λ[i, j, h] = exp(z_i - z_j) for j <= i, else 0, z = cumsum(loga)
    in loga's type; loga (Q, H)."""
    z = torch.cumsum(loga, 0)
    Q = loga.shape[0]
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()[:, :, None]
    return torch.where(causal, torch.exp(z[:, None] - z[None]), 0.0)


def tensor_core_chunk(xdt, loga, Bm, Cm, passes):
    """One chunk of y = (C Bᵀ ∘ Λ) x, both products as the kernel takes
    them: 3 TF32 products (passes=3) or one (passes=1), float32 sums;
    inputs (Q, H, ·) float32."""
    decay = chunk_decay(loga)
    ch, cl = tf32_split(Cm)
    bh, bl = tf32_split(Bm)
    S = torch.einsum("qhn,shn->qsh", ch, bh)
    if passes == 3:
        S = S + torch.einsum("qhn,shn->qsh", ch, bl) \
            + torch.einsum("qhn,shn->qsh", cl, bh)
    wh, wl = tf32_split(S * decay)
    xh, xl = tf32_split(xdt)
    y = torch.einsum("qsh,shp->qhp", wh, xh)
    if passes == 3:
        y = y + torch.einsum("qsh,shp->qhp", wh, xl) \
            + torch.einsum("qsh,shp->qhp", wl, xh)
    return y


@pytest.mark.parametrize("passes", [3, 1])
def test_tensor_core_split_and_the_f32_tolerance(passes):
    """At mamba2's widths (P 64, N 128, one 256-long chunk) and the
    serving draws (0.3 * normal, -softplus(normal)), 3xTF32 in float32
    lands within the f32 tolerance 1e-4 of the float64 result (here
    about 1.5e-5, most of it the float32 cumsum and exp that the plain
    version shares), and a single TF32 pass does not (about 1.5e-3):
    the kernel needs the split, and with it still sums in another order
    than the plain version, so it is held to 1e-4 and not bit for
    bit."""
    xdt, loga, Bm, Cm = (torch.from_numpy(a[0]) for a in
                         make_inputs(1, 256, 4, 64, 128, seed=0))
    got = tensor_core_chunk(xdt, loga, Bm, Cm, passes).double()
    x64, l64, b64, c64 = (t.double() for t in (xdt, loga, Bm, Cm))
    want = torch.einsum("qsh,shp->qhp", torch.einsum(
        "qhn,shn->qsh", c64, b64) * chunk_decay(l64), x64)
    within = ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()
    assert bool(within) == (passes == 3)
