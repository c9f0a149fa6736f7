"""The port's vlm (internvl2) against the JAX package.

The internvl2 smoke model (2 layers, 16 visual tokens of width 64 before
the text) in float32 gets the JAX package's initial parameters through
``convert.params_from_numpy``; ``forward`` (logits over the whole
[visual | text] sequence), ``loss_fn`` (the text region only), and
``prefill`` (the last position's logits and the cache over both
regions) with four ``serve_step``s are held against JAX's at 1e-4
(absolute and relative: both sides compute in float32 and differ only
in the order of their sums), one jit of the JAX model. Also: the
projector is an unstacked dict of the definitions, carried and drawn
whole, not cut into "layers"; the configs; ``make_batch``'s vlm batch;
the launcher on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.data import make_batch as jmake_batch
from repro.models import vlm as jvlm
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.data import make_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import convert, dense, vlm

ARCH = "internvl2-2b"
F32_TOL = 1e-4
PROMPT, STEPS = 12, 4


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def f32_case():
    jcfg = jconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    params = jax.tree.map(np.asarray, jmodels.init(jcfg, jax.random.key(1)))
    rng = np.random.default_rng(1)
    nv, dv = jcfg.vlm.n_visual_tokens, jcfg.vlm.d_visual
    visual = (rng.standard_normal((2, nv, dv)) * 0.3).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)

    @jax.jit
    def run(p, vis, tk):
        batch = {"visual_embeds": vis, "tokens": tk}
        fwd = jmodels.forward(jcfg, p, batch)
        loss = jmodels.loss_fn(jcfg, p, batch)
        logits, cache = jmodels.prefill(
            jcfg, p, {"visual_embeds": vis, "tokens": tk[:, :PROMPT]},
            pad_to=nv + PROMPT + STEPS)
        pre_cache, steps = cache, []
        for i in range(STEPS):
            lg, cache = jmodels.serve_step(
                jcfg, p, cache, tk[:, PROMPT + i:PROMPT + i + 1])
            steps.append(lg)
        return fwd, loss, logits, pre_cache, steps

    want = jax.tree.map(np.asarray, run(params, jnp.asarray(visual),
                                        jnp.asarray(toks)))
    cfg = tconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    return cfg, convert.params_from_numpy(cfg, params, "cpu"), visual, \
        toks, want, params


def test_forward_matches_jax(f32_case):
    cfg, model, visual, toks, (jfwd, *_), _ = f32_case
    got = tmodels.forward(cfg, model, {"visual_embeds": t(visual),
                                       "tokens": t(toks)})
    assert got.shape[1] == cfg.vlm.n_visual_tokens + toks.shape[1]
    np.testing.assert_allclose(f32(got), jfwd, atol=F32_TOL, rtol=F32_TOL)


def test_loss_matches_jax(f32_case):
    cfg, model, visual, toks, (_, jloss, *_), _ = f32_case
    loss = tmodels.loss_fn(cfg, model, {"visual_embeds": t(visual),
                                        "tokens": t(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), atol=F32_TOL,
                               rtol=F32_TOL)


def test_prefill_and_serve_steps_match_jax(f32_case):
    cfg, model, visual, toks, (_, _, jlogits, jcache, jsteps), _ = f32_case
    nv = cfg.vlm.n_visual_tokens
    batch = {"visual_embeds": t(visual), "tokens": t(toks[:, :PROMPT])}
    logits, cache = tmodels.prefill(cfg, model, batch,
                                    pad_to=nv + PROMPT + STEPS)
    np.testing.assert_allclose(f32(logits), jlogits, atol=F32_TOL,
                               rtol=F32_TOL)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape, name
        np.testing.assert_allclose(f32(cache[name]), jcache[name],
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=name)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(), jcache["kv_pos"])
    assert cache["next_pos"] == int(jcache["next_pos"]) == nv + PROMPT
    for i, want in enumerate(jsteps):
        lg, cache = tmodels.serve_step(cfg, model, cache,
                                       t(toks[:, PROMPT + i:PROMPT + i + 1]))
        np.testing.assert_allclose(f32(lg), want, atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"step {i}")


def test_projector_matches_jax(f32_case):
    cfg, model, visual, _, _, params = f32_case
    want = jvlm.project(cfg, params, jnp.asarray(visual))
    np.testing.assert_allclose(f32(vlm.project(cfg, model, t(visual))),
                               np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_converter_round_trips_the_tree_leaf_for_leaf(f32_case):
    """Every leaf of the JAX tree arrives whole or split into its layers
    by its definition's first axis: the projector's w1 (d_visual, D)
    stays one matrix, not d_visual "layers"."""
    cfg, model, _, _, _, params = f32_case
    defs = vlm.param_defs(cfg)
    n_leaves = 0
    for name, a in params.items():
        if not isinstance(a, dict):
            np.testing.assert_array_equal(f32(model.leaf(name)), a)
            n_leaves += 1
            continue
        for lname, la in a.items():
            if dense.is_stacked(defs[name][lname]):
                for li in range(cfg.n_layers):
                    np.testing.assert_array_equal(
                        f32(model.leaf(lname, li, name)), la[li])
            else:
                got = model.leaf(lname, None, name)
                assert tuple(got.shape) == la.shape
                np.testing.assert_array_equal(f32(got), la)
            n_leaves += 1
    assert n_leaves == len(params) - 2 + len(params["layers"]) \
        + len(params["projector"])
    assert tuple(model.projector.w1.shape) == (cfg.vlm.d_visual,
                                               cfg.d_model)


def test_init_draws_the_projector_whole():
    """init fills the projector's unstacked leaves with their own scales
    (w1 1/sqrt(d_visual), w2 1/sqrt(D), zero biases)."""
    cfg = tconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    cfg = cfg.replace(vlm=dataclasses.replace(cfg.vlm, d_visual=256))
    m = vlm.init(cfg, 0, device="cpu")
    pp = m.projector
    assert tuple(pp.w1.shape) == (256, cfg.d_model)
    assert abs(float(pp.w1.std()) * cfg.vlm.d_visual ** 0.5 - 1) < 0.03
    assert abs(float(pp.w2.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert not pp.b1.any() and not pp.b2.any()
    again = vlm.init(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(m.state_dict().values(), again.state_dict().values()))


def test_configs_and_param_count_match_jax():
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tconfigs, get)(ARCH)) \
            == dataclasses.asdict(getattr(jconfigs, get)(ARCH))
    n = tmodels.count_params(tconfigs.get_config(ARCH))
    assert n == jmodels.count_params(jconfigs.get_config(ARCH))
    assert round(n / 1e9, 3) == 1.895


@pytest.mark.parametrize("seq_len", [40, 12])
def test_vlm_batch_shapes_types_and_repeats(seq_len):
    """Patch embeddings (B, n_visual, d_visual) in the model's type,
    normal x 0.3; max(seq_len - n_visual, 8) text tokens, as the JAX
    pipeline makes them; the same batch for the same (seed, step)."""
    for dtype in ("bfloat16", "float32"):
        cfg = tconfigs.get_smoke_config(ARCH).replace(dtype=dtype)
        b = make_batch(cfg, 3, seq_len, 5, 2, device="cpu")
        want = jmake_batch(jconfigs.get_smoke_config(ARCH).replace(
            dtype=dtype), 3, seq_len, 5, 2)
        assert sorted(b) == sorted(want) == ["tokens", "visual_embeds"]
        for name in b:
            assert tuple(b[name].shape) == want[name].shape, name
            assert str(b[name].dtype).replace("torch.", "") \
                == str(want[name].dtype), name
        assert abs(float(b["visual_embeds"].float().std()) - 0.3) < 0.03
        again = make_batch(cfg, 3, seq_len, 5, 2, device="cpu")
        assert all(torch.equal(b[k], again[k]) for k in b)


def test_launcher_serves_every_new_arch_on_cpu():
    for arch in ("internvl2-2b", "whisper-large-v3", "qwen3-moe-30b-a3b",
                 "mixtral-8x22b"):
        res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--prompt-len", "40", "--decode-steps", "3"])
        assert tuple(res.tokens.shape) == (2, 4), arch
        assert all(bool(torch.isfinite(s).all()) for s in res.step_logits)
