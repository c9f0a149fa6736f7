"""The port's counter-based draws (``repro_torch.draws``) and the model
init built on them, on the CPU: the inverse normal CDF against the
exact quantile, and a model's values independent of how its leaves are
cut into slices (the card test in ``test_torch_kernels_cuda.py`` holds
the card's init and batches against the CPU's bit for bit)."""
import math
import statistics

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import draws, models
from repro_torch.data import make_batch


def test_ppf_and_log_match_the_exact_functions():
    """Acklam's inverse CDF is within 1.2e-9 relative of the exact
    quantile (beyond 1e-300 of either end), the series log within a few
    float64 steps of ``math.log``."""
    nd = statistics.NormalDist()
    p = [2.0 ** -33, 1e-9, 1e-5, 0.01, 0.02425, 0.0243, 0.1, 0.3, 0.5,
         0.7, 0.9, 0.97575, 0.99, 1 - 1e-7, 1 - 2.0 ** -33]
    got = draws.ppf(torch.tensor(p, dtype=torch.float64)).tolist()
    for pi, g in zip(p, got):
        want = nd.inv_cdf(pi)
        assert abs(g - want) <= 1.2e-9 * max(abs(want), 1.0), (pi, g, want)
    x = [1e-300, 2.0 ** -33, 1e-10, 0.3, 0.70710678, 0.9, 1.0, 1.5, 2.0,
         1e10]
    got = draws._log(torch.tensor(x, dtype=torch.float64)).tolist()
    for xi, g in zip(x, got):
        assert abs(g - math.log(xi)) <= 4e-16 * max(abs(math.log(xi)), 1.0)


def test_normals_do_not_depend_on_the_slicing():
    """Elements i of a draw are the same whether drawn in one piece or
    two, across the 2**32 boundary where the high word changes."""
    k = draws.key(7, 3)
    whole = draws.normals(k, 2 ** 32 - 100, 300, "cpu")
    parts = torch.cat([draws.normals(k, 2 ** 32 - 100, 137, "cpu"),
                       draws.normals(k, 2 ** 32 + 37, 163, "cpu")])
    assert torch.equal(whole, parts)
    assert not torch.equal(whole, draws.normals(draws.key(7, 4),
                                                2 ** 32 - 100, 300, "cpu"))
    u = draws.uniforms(k, 0, 1 << 16, "cpu")
    assert float(u.min()) > 0 and float(u.max()) < 1
    n = draws.normals(k, 0, 1 << 16, "cpu")
    assert abs(float(n.mean())) < 0.02 and abs(float(n.std()) - 1) < 0.02


@pytest.mark.parametrize("arch", ["stablelm-12b", "mamba2-1.3b",
                                  "recurrentgemma-9b"])
def test_init_is_the_same_whatever_the_slice_size(monkeypatch, arch):
    """A model drawn in slices of 1,000 or 4,096 elements equals the
    one drawn in the default slices, leaf for leaf (each layer's slice
    of a stack at its offset in the stacked leaf); another seed gives
    other values."""
    cfg = tconfigs.get_smoke_config(arch)
    want = models.init(cfg, 3, device="cpu").state_dict()
    for size in (1000, 4096):
        monkeypatch.setattr(draws, "SLICE", size)
        got = models.init(cfg, 3, device="cpu").state_dict()
        assert list(got) == list(want)
        for name in want:
            assert torch.equal(got[name], want[name]), (size, name)
    other = models.init(cfg, 4, device="cpu").state_dict()
    assert not torch.equal(other["top.embed"], want["top.embed"])


def test_make_batch_is_a_function_of_seed_and_step():
    cfg = tconfigs.get_smoke_config("stablelm-12b")
    a = make_batch(cfg, 2, 16, 5, 3, device="cpu")["tokens"]
    assert torch.equal(a, make_batch(cfg, 2, 16, 5, 3,
                                     device="cpu")["tokens"])
    assert not torch.equal(a, make_batch(cfg, 2, 16, 5, 4,
                                         device="cpu")["tokens"])
    assert a.dtype == torch.int32 and 0 <= int(a.min()) <= int(a.max()) \
        < cfg.vocab
