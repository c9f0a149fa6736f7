"""The port's ``lru_scan`` against the JAX package.

The plain PyTorch version ``lru_scan_torch`` (and ``ops.lru_scan``,
which runs it for CPU tensors) is held against the ``ref.lru_scan_ref``
oracle at the shapes of ``tests/test_kernels.py::TestLruScan`` (ragged
L and R, with and without h0) in float32 (tolerance 1e-4) and bfloat16
(5e-2, the JAX suite's scan tolerances: the oracle takes an associative
scan and the port a sequential one, which round in other places), and
against ``repro.models.hybrid.lru_scan``, the recurrence the JAX hybrid
runs. Not against the Pallas ``lru_scan``: it calls ``pl.store``, which
the installed jax no longer has. The CUDA kernel is held against the
plain version on the card in ``tests/test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import hybrid as jhybrid
from repro_torch.kernels import lru_scan as tls
from repro_torch.kernels import ops as tops

# (B, L, R, h0): tests/test_kernels.py::TestLruScan
SHAPES = [(2, 256, 512, False), (2, 300, 130, True), (1, 64, 1024, True),
          (3, 1024, 64, False)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def make_inputs(B, L, R, with_h0, seed):
    """a = sigmoid(normal), b = 0.5 * normal, h0 normal, from numpy."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, L, R), np.float32)))
    b = rng.standard_normal((B, L, R), np.float32) * 0.5
    h0 = rng.standard_normal((B, R), np.float32) if with_h0 else None
    return a.astype(np.float32), b, h0


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_oracle(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    a, b, h0 = make_inputs(*shape, seed=shape[1] * shape[2])
    j = [None if x is None else jnp.asarray(x).astype(jdt) for x in (a, b, h0)]
    t = [None if x is None else torch.from_numpy(x).to(tdt)
         for x in (a, b, h0)]
    got = tls.lru_scan_torch(*t)
    assert got.dtype == tdt and tuple(got.shape) == shape[:3]
    np.testing.assert_allclose(f32(got), f32(jref.lru_scan_ref(*j)),
                               atol=tol, rtol=tol)
    assert torch.equal(tops.lru_scan(*t), got)


@pytest.mark.parametrize("with_h0", [False, True])
def test_matches_hybrid_lru(with_h0):
    a, b, h0 = make_inputs(2, 64, 32, with_h0, seed=7)
    want = jhybrid.lru_scan(jnp.asarray(a), jnp.asarray(b),
                            None if h0 is None else jnp.asarray(h0))
    got = tls.lru_scan_torch(torch.from_numpy(a), torch.from_numpy(b),
                             None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-4, rtol=1e-4)


def test_h0_is_carried_in_float32():
    """A bf16 h0 widens to float32 before the first step; the output
    takes a's type."""
    a, b, h0 = make_inputs(1, 8, 16, True, seed=2)
    got = tls.lru_scan_torch(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(h0).to(torch.bfloat16))
    h = torch.from_numpy(h0).to(torch.bfloat16).float()
    for t in range(8):
        h = torch.from_numpy(a[:, t]) * h + torch.from_numpy(b[:, t])
    assert got.dtype == torch.float32
    assert torch.equal(got[:, -1], h)


def test_cpu_path_launches_no_kernel_and_wrapper_refuses_cpu():
    a, b, _ = (None if x is None else torch.from_numpy(x)
               for x in make_inputs(1, 16, 8, False, 1))
    before = dict(tops.LAUNCHES)
    tops.lru_scan(a, b)
    assert tops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tls.lru_scan_cuda(a, b)
