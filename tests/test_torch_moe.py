"""The port's mixture-of-experts LM against the JAX package.

Both moe smoke configs (qwen3-moe, 4 experts top-2; mixtral, 4 experts
top-2 under a 64-token window) in float32 get the JAX package's initial
parameters through ``convert.params_from_numpy``; ``forward``,
``loss_fn`` (cross entropy plus the router's load-balance loss) and
``prefill`` with four ``serve_step``s are held against JAX's at 1e-4
(absolute and relative: both sides compute in float32 and differ only
in the order of their sums), one jit of the JAX model per config.

The routed sublayer is held against JAX's scatter ``moe_block`` and its
dense one-hot oracle ``moe_block_einsum`` (float32 1e-4; bfloat16 5e-2
of the output's max, 8 significant bits rounded at other points), and
its routing integers (the experts picked, each assignment's rank in its
expert, the kept mask and the slots) equal JAX's exactly: in a case
forced to drop (capacity factor 0.5), in a case of exact ties (a zero
router, every probability equal, where JAX picks experts 0..k-1 and
the port's stable sort must too), and with the load-balance loss. Also
the configs and parameter counts of the two full configs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.models import common, convert, moe

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x22b"]
F32_TOL = 1e-4
PROMPT, STEPS = 24, 4


def jax_params(jcfg, seed):
    return jax.tree.map(np.asarray, jmodels.init(jcfg, jax.random.key(seed)))


def tokens_for(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def run_jax(jcfg, params, toks):
    """forward, loss_fn, prefill and STEPS serve_steps of the JAX model,
    in one jit."""
    @jax.jit
    def run(p, tk):
        batch = {"tokens": tk}
        fwd = jmodels.forward(jcfg, p, batch)
        loss = jmodels.loss_fn(jcfg, p, batch)
        logits, cache = jmodels.prefill(jcfg, p, {"tokens": tk[:, :PROMPT]},
                                        pad_to=PROMPT + STEPS)
        steps = []
        for i in range(STEPS):
            lg, cache = jmodels.serve_step(
                jcfg, p, cache, tk[:, PROMPT + i:PROMPT + i + 1])
            steps.append(lg)
        return fwd, loss, logits, steps

    return jax.tree.map(f32, run(params, jnp.asarray(toks)))


@pytest.fixture(scope="module", params=ARCHS)
def f32_case(request):
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32")
    params = jax_params(jcfg, seed=1)
    toks = tokens_for(jcfg.vocab, 2, PROMPT + STEPS, 1)
    cfg = tconfigs.get_smoke_config(arch).replace(dtype="float32")
    return cfg, convert.params_from_numpy(cfg, params, "cpu"), toks, \
        run_jax(jcfg, params, toks)


def test_forward_matches_jax(f32_case):
    cfg, model, toks, (jfwd, _, _, _) = f32_case
    np.testing.assert_allclose(
        f32(tmodels.forward(cfg, model, {"tokens": t(toks)})), jfwd,
        atol=F32_TOL, rtol=F32_TOL)


def test_loss_matches_jax(f32_case):
    cfg, model, toks, (_, jloss, _, _) = f32_case
    loss = tmodels.loss_fn(cfg, model, {"tokens": t(toks)})
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), jloss, atol=F32_TOL,
                               rtol=F32_TOL)


def test_prefill_and_serve_steps_match_jax(f32_case):
    cfg, model, toks, (_, _, jlogits, jsteps) = f32_case
    logits, cache = tmodels.prefill(cfg, model,
                                    {"tokens": t(toks[:, :PROMPT])},
                                    pad_to=PROMPT + STEPS)
    np.testing.assert_allclose(f32(logits), jlogits, atol=F32_TOL,
                               rtol=F32_TOL)
    for i, want in enumerate(jsteps):
        lg, cache = tmodels.serve_step(cfg, model, cache,
                                       t(toks[:, PROMPT + i:PROMPT + i + 1]))
        np.testing.assert_allclose(f32(lg), want, atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"step {i}")
    assert cache["next_pos"] == PROMPT + STEPS


def test_loss_has_gradients_for_every_parameter(f32_case):
    """The training route reaches every leaf, the router through its
    load-balance term and the gates."""
    cfg, _, toks, _ = f32_case
    model = tmodels.init(cfg, 0, device="cpu").requires_grad_(True)
    tmodels.loss_fn(cfg, model, {"tokens": t(toks)}).backward()
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    assert not missing, missing


# ---------------------------------------------------------------------------
# The routed sublayer
# ---------------------------------------------------------------------------

def block_case(arch, dtype, seed, S=32, **moe_kw):
    """(port cfg, port MoEMLP, JAX cfg, JAX layer-0 params, x numpy)."""
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype=dtype)
    cfg = tconfigs.get_smoke_config(arch).replace(dtype=dtype)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    params = jax_params(jcfg, seed)
    mlp = convert.params_from_numpy(cfg, params, "cpu").layers[0].mlp
    lp = jax.tree.map(lambda p: jnp.asarray(p[0]), params["layers"])
    x = np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    return cfg, mlp, jcfg, lp, x


def jax_dispatch(idx, E, C):
    """The JAX ``moe_block``'s rank, kept mask and slot of each (token,
    k) assignment of one group (``repro/models/moe.py`` one_group)."""
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.float32)
    rank = jnp.cumsum(onehot, axis=0) - 1.0
    pos = jnp.sum(rank * onehot, axis=-1).astype(jnp.int32)
    keep = pos < C
    return pos, keep, jnp.where(keep, flat_e * C + pos, E * C)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax_and_einsum_oracle(arch, dtype, tol):
    cfg, mlp, jcfg, lp, x = block_case(arch, dtype, seed=2)
    xt = torch.from_numpy(x).to(common.torch_dtype(dtype))
    out, aux = moe.moe_block(cfg, mlp, xt)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = jax.jit(lambda p, v: (jmoe.moe_block(jcfg, p, v),
                                 jmoe.moe_block_einsum(jcfg, p, v)))(lp, xj)
    for (w, waux), name in zip(want, ("moe_block", "moe_block_einsum")):
        w = f32(w)
        assert out.dtype == xt.dtype and out.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(f32(out), w, atol=tol, rtol=tol,
                                       err_msg=name)
        else:
            assert np.abs(f32(out) - w).max() <= tol * np.abs(w).max(), name
        np.testing.assert_allclose(float(aux), float(waux), rtol=1e-4,
                                   err_msg=name)


def routing(arch, seed, S=32, zero_router=False, **moe_kw):
    """The routing integers of layer 0 on both sides, float32: (port
    (idx, pos, keep, slot, aux), JAX (idx, pos, keep, slot, aux), C)."""
    cfg, mlp, jcfg, lp, x = block_case(arch, "float32", seed, S, **moe_kw)
    if zero_router:
        mlp.w_router.zero_()
        lp = dict(lp, w_router=jnp.zeros_like(lp["w_router"]))
    E, C = cfg.moe.num_experts, moe.capacity(cfg, S)
    h = common.rms_norm(torch.from_numpy(x), mlp.mlp_norm, cfg.norm_eps)
    _, idx, aux = moe.route(cfg, mlp, h)
    pos, keep = moe.dispatch(idx, E, C)
    slot = torch.where(keep, idx.reshape(2, -1) * C + pos, E * C)
    hj = jcommon.rms_norm(jnp.asarray(x), lp["mlp_norm"], jcfg.norm_eps)
    _, jidx, jaux = jmoe._route(jcfg, lp, hj)
    jd = [jax_dispatch(jidx[b], E, C) for b in range(2)]
    want = (np.asarray(jidx),) + tuple(np.stack([np.asarray(d[i])
                                                 for d in jd])
                                       for i in range(3)) + (float(jaux),)
    got = (idx.numpy(), pos.numpy(), keep.numpy(), slot.numpy(), float(aux))
    return got, want, C


def assert_routing_equal(got, want):
    for g, w, name in zip(got[:4], want[:4], ("idx", "pos", "keep", "slot")):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_drops_as_jax(arch):
    """Capacity factor 0.5: C = 8 slots an expert for 64 assignments a
    group over 4 experts, so assignments drop; the same ones as in JAX."""
    got, want, C = routing(arch, seed=3, capacity_factor=0.5)
    assert C == 8
    assert not got[2].all()              # some assignment dropped
    assert_routing_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_ties_go_to_the_lowest_expert(arch):
    """A zero router: every probability is 1/E, JAX's top_k picks
    experts 0..k-1 for every token, and so must the port's stable
    sort; ranks and drops follow."""
    got, want, C = routing(arch, seed=4, zero_router=True)
    k = tconfigs.get_smoke_config(arch).moe.top_k
    assert (got[0] == np.arange(k)).all()
    assert not got[2].all()              # 32 tokens each on experts 0, 1
    assert_routing_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_aux_loss_match_jax(arch):
    got, want, _ = routing(arch, seed=5)
    assert_routing_equal(got, want)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_assignments_add_exactly_zero(arch, monkeypatch):
    """A zero router sends every token to experts 0..k-1, so assignments
    drop and the last expert's slots stay unused. With inf planted in
    the last expert's last slot the output stays finite and unchanged:
    a dropped assignment reads 0 (JAX's gather fills 0), not a slot
    times a weight of 0."""
    cfg, mlp, _, _, x = block_case(arch, "float32", seed=6)
    xt = torch.from_numpy(x)
    expert_ffn = moe._expert_ffn

    def planted(*args):
        y = expert_ffn(*args)
        y[-1, -1] = float("inf")
        return y

    with torch.no_grad():
        mlp.w_router.zero_()
        h = common.rms_norm(xt, mlp.mlp_norm, cfg.norm_eps)
        _, keep = moe.dispatch(moe.route(cfg, mlp, h)[1],
                               cfg.moe.num_experts, moe.capacity(cfg, 32))
        want, _ = moe.moe_block(cfg, mlp, xt)
        monkeypatch.setattr(moe, "_expert_ffn", planted)
        got, _ = moe.moe_block(cfg, mlp, xt)
    assert not keep.all()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_decode_capacity_drops_nothing():
    """One token a group: C = 4 (the padded minimum) and top-k picks
    distinct experts, so serve_step never drops."""
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        assert moe.capacity(cfg, 1) == 4 >= 1


def test_top_k_is_stable_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    vals, idx = moe.top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 2]]
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(jidx).tolist()


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,billions", [("qwen3-moe-30b-a3b", 30.532),
                                           ("mixtral-8x22b", 140.63)])
def test_configs_and_param_counts_match_jax(arch, billions):
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tconfigs, get)(arch)) \
            == dataclasses.asdict(getattr(jconfigs, get)(arch))
    n = tmodels.count_params(tconfigs.get_config(arch))
    assert n == jmodels.count_params(jconfigs.get_config(arch))
    assert round(n / 1e9, 3 if billions < 100 else 2) == billions
