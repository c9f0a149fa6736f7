"""The port's fused schedule pass against the JAX package's three
backends: the plain PyTorch version ``schedule_step_torch`` must equal
``schedule_step_jnp``, the ``ref.schedule_step_ref`` oracle and the
Pallas ``ops.schedule_step`` (interpret mode on the CPU) bit for bit on
all 8 ``SchedulePass`` fields. Inputs are integer tiles drawn from
numpy seeds, where every score and slack is exact in float32. The CUDA
kernel itself is held against the plain version on the card
(``cuda`` marker; skipped here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine.placement import FIT_EPS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import schedule_step as jss
from repro_torch.kernels import ops as tops
from repro_torch.kernels import schedule_step as tss

FIELDS = tss.SchedulePass._fields


def rand_instance(J, M, seed):
    """Random gang-shaped pass inputs (numpy): single-node and 2-node
    gang assignments, mixed masks, random queue keys."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    demand = np.stack([rng.integers(1, 33, J), rng.integers(1, 257, J),
                       rng.integers(0, 9, J)], 1).astype(f32)
    free = np.stack([rng.integers(0, 16, M), rng.integers(0, 128, M),
                     rng.integers(0, 5, M)], 1).astype(f32)
    pend = np.stack([rng.integers(0, 8, M), rng.integers(0, 64, M),
                     rng.integers(0, 3, M)], 1).astype(f32)
    node = rng.integers(0, M, J)
    gang = rng.random(J) < 0.3
    assign = np.zeros((J, M), bool)
    assign[np.arange(J), node] = True
    assign[np.arange(J)[gang], (node[gang] + 1) % M] = True
    gp = rng.integers(0, 21, J).astype(f32)
    width = np.where(gang, 2, 1).astype(np.int32)
    queue_key = (rng.random(J) * 100.0).astype(f32)
    cand = rng.random(J) < 0.7
    under = rng.random(J) < 0.9
    be_q = rng.random(J) < 0.4
    te = np.array([4.0, 16.0, 4.0], f32)
    cap = np.array([32.0, 256.0, 8.0], f32)
    return dict(demand=demand, gp=gp, width=width, queue_key=queue_key,
                assign=assign, free=free, pending_free=pend, cand=cand,
                under=under, be_q=be_q, te_demand=te, node_cap=cap)


def trivial_instance(**over):
    """The JAX suite's deterministic 5-job, 2-node edge-case tile."""
    J, M = 5, 2
    assign = np.zeros((J, M), bool)
    assign[:, 0] = True
    base = dict(
        demand=np.tile(np.array([[4.0, 16.0, 1.0]], np.float32), (J, 1)),
        gp=np.arange(J, dtype=np.float32),
        width=np.ones(J, np.int32),
        queue_key=np.arange(J, dtype=np.float32),
        assign=assign,
        free=np.array([[32.0, 256.0, 8.0]] * M, np.float32),
        pending_free=np.zeros((M, 3), np.float32),
        cand=np.zeros(J, bool), under=np.ones(J, bool),
        be_q=np.zeros(J, bool),
        te_demand=np.array([8.0, 32.0, 2.0], np.float32),
        node_cap=np.array([32.0, 256.0, 8.0], np.float32))
    base.update(over)
    return base


def jax_normalizers(inst):
    """The JAX wrapper's normalizers (kernels/ops.py), in jnp."""
    d = jnp.asarray(inst["demand"])
    cap = jnp.asarray(inst["node_cap"])
    cand = jnp.asarray(inst["cand"])
    sz = jnp.sqrt(jnp.sum(jnp.square(d / cap), -1))
    max_sz = jnp.maximum(jnp.max(jnp.where(cand, sz, 0.0)), 1e-12)
    max_gp = jnp.maximum(jnp.max(jnp.where(
        cand, jnp.asarray(inst["gp"]), 0.0)), 1e-12)
    return max_sz, max_gp


def jax_backends(inst, s=4.0, pallas=True):
    """(jnp twin, ref oracle[, Pallas interpret]) passes as numpy."""
    args = [jnp.asarray(v) for v in inst.values()]
    max_sz, max_gp = jax_normalizers(inst)
    out = [jss.schedule_step_jnp(*args, max_sz, max_gp, s),
           jss.SchedulePass(*jref.schedule_step_ref(
               *args, max_sz, max_gp, s, eps=FIT_EPS))]
    if pallas:
        out.append(jops.schedule_step(*args, s=s, block_j=16))
    return [[np.asarray(x) for x in ps] for ps in out], \
        (float(max_sz), float(max_gp))


def torch_args(inst):
    return [torch.as_tensor(v) for v in inst.values()]


def assert_pass_equal(a, b):
    for name, x, y in zip(FIELDS, a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)
        assert x.dtype == np.asarray(y).dtype, name


def plain_pass(inst, s=4.0):
    max_sz, max_gp = tops.normalizers(*(torch.as_tensor(inst[k]) for k in (
        "demand", "gp", "cand", "node_cap")))
    return tss.schedule_step_torch(*torch_args(inst), max_sz, max_gp, s)


@pytest.mark.parametrize("J,M,seed", [
    (4, 8, 0), (37, 8, 1), (128, 8, 2), (300, 8, 3), (512, 84, 4),
    (97, 84, 5), (1, 3, 6), (250, 16, 7)])
def test_plain_matches_jnp_and_oracle(J, M, seed):
    inst = rand_instance(J, M, seed)
    (twin, oracle), _ = jax_backends(inst, pallas=False)
    ps = plain_pass(inst)
    assert_pass_equal(ps, twin)
    assert_pass_equal(ps, oracle)


@pytest.mark.parametrize("J,seed", [(45, 11), (130, 12), (16, 13)])
def test_ops_matches_pallas_interpret(J, seed):
    """The port's ops wrapper (normalizers + plain pass on CPU
    tensors) equals the JAX ops wrapper over the Pallas kernel in
    interpret mode, ragged J padded on the JAX side."""
    inst = rand_instance(J, 8, seed)
    (_, _, pallas), _ = jax_backends(inst)
    args = torch_args(inst)
    ps = tops.schedule_step(*args, s=4.0)
    assert_pass_equal(ps, pallas)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalizers_match_jax_wrapper(seed):
    inst = rand_instance(200, 8, seed)
    _, (max_sz, max_gp) = jax_backends(inst, pallas=False)
    t_sz, t_gp = tops.normalizers(*(torch.as_tensor(inst[k]) for k in (
        "demand", "gp", "cand", "node_cap")))
    assert t_sz.dtype == torch.float32 and t_gp.dtype == torch.float32
    assert float(t_sz) == max_sz and float(t_gp) == max_gp


@pytest.mark.parametrize("no_cand", [False, True])
def test_given_norms_equal_computed(no_cand):
    """A caller's (max_sz, max_gp) pair gives the pass the wrapper
    computes itself from the same ``cand``."""
    inst = rand_instance(96, 8, 14)
    if no_cand:
        inst["cand"][:] = False
    args = torch_args(inst)
    norms = tops.normalizers(args[0], args[1], args[7], args[11])
    assert_pass_equal(tops.schedule_step(*args, norms=norms),
                      [x.numpy() for x in tops.schedule_step(*args)])


def test_normalizers_clamp_without_candidates():
    inst = rand_instance(20, 4, 9)
    inst["cand"][:] = False
    _, (max_sz, max_gp) = jax_backends(inst, pallas=False)
    t_sz, t_gp = tops.normalizers(*(torch.as_tensor(inst[k]) for k in (
        "demand", "gp", "cand", "node_cap")))
    assert float(t_sz) == max_sz == np.float32(1e-12)
    assert float(t_gp) == max_gp


class TestEdgeCases:
    """The JAX suite's deterministic edge cases, on every backend."""

    def check(self, inst):
        backends, _ = jax_backends(inst)
        ps = plain_pass(inst)
        for other in backends:
            assert_pass_equal(ps, other)
        return ps

    def test_empty_queue_no_victim(self):
        ps = self.check(trivial_instance())
        assert (int(ps.victim), int(ps.be_head), int(ps.be_pick),
                int(ps.nskip)) == (-1, -1, -1, 0)

    def test_every_mask_set(self):
        ps = self.check(trivial_instance(cand=np.ones(5, bool),
                                         be_q=np.ones(5, bool)))
        assert int(ps.be_head) == 0 and int(ps.be_pick) == 0
        assert tuple(ps.fits.shape) == (5, 2)

    def test_gang_best_node_reduction(self):
        free = np.array([[0.0, 0.0, 0.0], [32.0, 256.0, 8.0]], np.float32)
        assign = np.zeros((5, 2), bool)
        assign[0] = True
        assign[1, 0] = True
        over = dict(demand=np.tile(np.array([[4.0, 16.0, 2.0]], np.float32),
                                   (5, 1)),
                    free=free, cand=np.arange(5) < 2, assign=assign)
        assert int(self.check(trivial_instance(**over)).victim) == 0
        over["assign"] = np.zeros((5, 2), bool)
        over["assign"][:2, 0] = True
        assert int(self.check(trivial_instance(**over)).victim) == -1

    def test_backfill_pick_and_skips(self):
        demand = np.array([[64.0, 16.0, 1.0], [64.0, 16.0, 1.0],
                           [4.0, 16.0, 1.0], [4.0, 16.0, 1.0],
                           [4.0, 16.0, 1.0]], np.float32)
        ps = self.check(trivial_instance(demand=demand,
                                         be_q=np.arange(5) < 4))
        assert (int(ps.be_head), int(ps.be_pick), int(ps.nskip)) == (0, 2, 2)
        np.testing.assert_array_equal(ps.fit_now.numpy(), [0, 0, 2, 2, 2])

    def test_ties_take_the_lowest_index(self):
        """Equal scores and equal keys: every argmin is the first."""
        ps = self.check(trivial_instance(
            gp=np.zeros(5, np.float32), queue_key=np.full(5, 7.0, np.float32),
            cand=np.ones(5, bool), be_q=np.arange(5) >= 2))
        assert (int(ps.victim), int(ps.be_head), int(ps.be_pick)) == (0, 2, 2)


def test_batched_equals_rowwise():
    """The leading batch axis: B stacked tiles (own normalizers and s
    per row) give each row's unbatched pass."""
    insts = [rand_instance(64, 8, 20 + b) for b in range(3)]
    s = torch.tensor([4.0, 0.0, 1.5])
    norms = [tops.normalizers(*(torch.as_tensor(i[k]) for k in (
        "demand", "gp", "cand", "node_cap"))) for i in insts]
    stacked = [torch.stack([torch.as_tensor(i[k]) for i in insts])
               for k in insts[0]]
    max_sz = torch.stack([n[0] for n in norms])
    max_gp = torch.stack([n[1] for n in norms])
    ps = tss.schedule_step_torch(*stacked, max_sz, max_gp, s)
    for b, inst in enumerate(insts):
        row = tss.schedule_step_torch(*torch_args(inst), norms[b][0],
                                      norms[b][1], float(s[b]))
        assert_pass_equal([x[b] for x in ps], row)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts
    no kernel launch; the CUDA wrapper refuses CPU tensors."""
    inst = rand_instance(32, 8, 3)
    before = tops.LAUNCHES["schedule_step"]
    tops.schedule_step(*torch_args(inst))
    assert tops.LAUNCHES["schedule_step"] == before
    with pytest.raises(ValueError, match="CUDA"):
        tss.schedule_step_cuda(*torch_args(inst), 1.0, 1.0, 4.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,J,M,seed", [
    (1, 5, 8, 0), (1, 1000, 84, 1), (4, 1000, 8, 2), (1, 65536, 84, 3)])
def test_kernel_matches_plain_on_card(cuda_device, B, J, M, seed):
    insts = [rand_instance(J, M, seed + b) for b in range(B)]
    args = [torch.stack([torch.as_tensor(i[k]) for i in insts])
            .to(cuda_device) for k in insts[0]]
    norms = [tops.normalizers(args[0][b], args[1][b], args[7][b],
                              args[11][b]) for b in range(B)]
    max_sz = torch.stack([n[0] for n in norms])
    max_gp = torch.stack([n[1] for n in norms])
    s = torch.full((B,), 4.0, device=cuda_device)
    k = tss.schedule_step_cuda(*args, max_sz, max_gp, s)
    p = tss.schedule_step_torch(*args, max_sz, max_gp, s)
    torch.cuda.synchronize()
    assert_pass_equal([x.cpu() for x in k], [x.cpu() for x in p])
