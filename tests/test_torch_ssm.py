"""The port's Mamba-2 (SSD) LM against the JAX package.

The layer functions (``causal_conv``, ``conv_step``, ``segsum``,
``ssd_scan`` over several chunks from an initial state, ``ssd_step``)
are held against ``repro.models.ssm``'s on the same numpy inputs. The
mamba2 smoke model in float32 gets the JAX package's initial parameters
through ``convert.params_from_numpy``; its ``forward``, its ``prefill``
of a prompt that is not a multiple of the 32-token chunk (last-token
logits and the whole cache) and four ``serve_step`` logits are held
against JAX's. The float32 tolerance is 1e-4 (absolute and relative):
both sides compute in float32 and differ only in the order of their
sums. In bfloat16 the logits are held to 5e-2 of max|logit|: bf16 keeps
8 significant bits, the two frameworks round activations at different
points, and JAX's jnp ``y_diag`` rounds its C·Bᵀ scores to bf16 where
the port (like the Pallas kernel) keeps them in float32. Also: the
configs, the converter, decode against the full forward within the
port, and the launcher on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import convert, ssm

ARCH = "mamba2-1.3b"
F32_TOL = 1e-4
PROMPT, STEPS = 45, 4       # 45 = one 32-token chunk and 13 of the next


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


def run_jax(dtype, seed):
    jcfg = jconfigs.get_smoke_config(ARCH).replace(dtype=dtype)
    params = jax_params(jcfg, seed)
    toks = tokens_for(jcfg.vocab, 2, PROMPT + STEPS, seed)
    logits, cache = jmodels.prefill(
        jcfg, params, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    pre = (f32(logits), jax.tree.map(np.asarray, cache))
    steps = []
    for i in range(STEPS):
        lg, cache = jmodels.serve_step(
            jcfg, params, cache, jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]))
        steps.append(f32(lg))
    fwd = f32(jmodels.forward(jcfg, params, {"tokens": jnp.asarray(toks)}))
    return params, toks, pre, steps, fwd


@pytest.fixture(scope="module")
def f32_case():
    params, toks, pre, steps, fwd = run_jax("float32", seed=1)
    cfg = tconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    return cfg, convert.params_from_numpy(cfg, params, "cpu"), toks, pre, \
        steps, fwd


def port_prefill(cfg, model, toks):
    return tmodels.prefill(cfg, model, {"tokens": t(toks[:, :PROMPT])},
                           pad_to=PROMPT + STEPS)


def test_forward_matches_jax(f32_case):
    cfg, model, toks, _, _, jfwd = f32_case
    np.testing.assert_allclose(f32(tmodels.forward(cfg, model,
                                                   {"tokens": t(toks)})),
                               jfwd, atol=F32_TOL, rtol=F32_TOL)


def test_prefill_matches_jax(f32_case):
    cfg, model, toks, (jlogits, jcache), _, _ = f32_case
    logits, cache = port_prefill(cfg, model, toks)
    assert tuple(logits.shape) == (2, 1, cfg.vocab)
    np.testing.assert_allclose(f32(logits), jlogits, atol=F32_TOL,
                               rtol=F32_TOL)
    for k in ("x", "B", "C"):
        assert cache["conv"][k].shape == jcache["conv"][k].shape
        np.testing.assert_allclose(f32(cache["conv"][k]), jcache["conv"][k],
                                   atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(f32(cache["state"]), jcache["state"],
                               atol=F32_TOL, rtol=F32_TOL)
    assert cache["next_pos"] == int(jcache["next_pos"]) == PROMPT


def test_serve_steps_match_jax(f32_case):
    cfg, model, toks, _, jsteps, _ = f32_case
    _, cache = port_prefill(cfg, model, toks)
    for i, want in enumerate(jsteps):
        logits, cache = tmodels.serve_step(
            cfg, model, cache, t(toks[:, PROMPT + i:PROMPT + i + 1]))
        np.testing.assert_allclose(f32(logits), want, atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"step {i}")
    assert cache["next_pos"] == PROMPT + STEPS


def test_bf16_model_matches_jax():
    params, toks, (jlogits, jcache), jsteps, jfwd = run_jax("bfloat16",
                                                            seed=2)
    cfg = tconfigs.get_smoke_config(ARCH)
    assert cfg.dtype == "bfloat16"
    model = convert.params_from_numpy(cfg, params, "cpu")
    logits, cache = port_prefill(cfg, model, toks)
    assert cache["state"].dtype == torch.bfloat16     # as JAX keeps it
    got = [f32(logits)]
    for i in range(STEPS):
        lg, cache = tmodels.serve_step(cfg, model, cache,
                                       t(toks[:, PROMPT + i:PROMPT + i + 1]))
        got.append(f32(lg))
    got.append(f32(tmodels.forward(cfg, model, {"tokens": t(toks)})))
    for g, w in zip(got, [jlogits, *jsteps, jfwd]):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max()


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_and_conv_step_match_jax(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 6), np.float32)
    w = rng.standard_normal((4, 6), np.float32)
    st = rng.standard_normal((2, 3, 6), np.float32) if with_state else None
    y, fin = ssm.causal_conv(t(x), t(w), None if st is None else t(st))
    jy, jfin = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(f32(y), f32(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(f32(fin), f32(jfin))
    st = np.zeros((2, 3, 6), np.float32) if st is None else st
    y1, s1 = ssm.conv_step(t(x[:, 0]), t(w), t(st))
    jy1, js1 = jssm.conv_step(jnp.asarray(x[:, 0]), jnp.asarray(w),
                              jnp.asarray(st))
    np.testing.assert_allclose(f32(y1), f32(jy1), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(f32(s1), f32(js1))


def scan_inputs(B, L, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, H, P), np.float32) * 0.3,
            (-np.logaddexp(rng.standard_normal((B, L, H)), 0.0))
            .astype(np.float32),
            rng.standard_normal((B, L, G, N), np.float32) * 0.3,
            rng.standard_normal((B, L, G, N), np.float32) * 0.3,
            rng.standard_normal((B, H, P, N), np.float32) * 0.3)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_scan_matches_jax(G):
    """Four chunks from an initial state, heads broadcast from G groups."""
    xdt, loga, Bm, Cm, h0 = scan_inputs(2, 64, 4, 8, G, 6, seed=4 + G)
    y, fin = ssm.ssd_scan(t(xdt), t(loga), t(Bm), t(Cm), 16, t(h0))
    jy, jfin = jssm.ssd_scan(*(jnp.asarray(a) for a in (xdt, loga, Bm, Cm)),
                             16, jnp.asarray(h0))
    np.testing.assert_allclose(f32(y), f32(jy), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(f32(fin), f32(jfin), atol=F32_TOL,
                               rtol=F32_TOL)
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssd_scan(t(xdt), t(loga), t(Bm), t(Cm), 24)


def test_ssd_step_and_segsum_match_jax():
    xdt, loga, Bm, Cm, h0 = scan_inputs(2, 1, 4, 8, 2, 6, seed=6)
    rng = np.random.default_rng(6)
    dt = rng.random((2, 4), np.float32)
    A_log = rng.standard_normal(4, np.float32) * 0.1
    y, st = ssm.ssd_step(t(h0), t(xdt[:, 0]), t(dt), t(A_log), t(Bm[:, 0]),
                         t(Cm[:, 0]))
    jy, jst = jssm.ssd_step(jnp.asarray(h0), jnp.asarray(xdt[:, 0]),
                            jnp.asarray(dt), jnp.asarray(A_log),
                            jnp.asarray(Bm[:, 0]), jnp.asarray(Cm[:, 0]))
    np.testing.assert_allclose(f32(y), f32(jy), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(f32(st), f32(jst), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(f32(ssm.segsum(t(loga[0, :, 0][None]))),
                               f32(jssm.segsum(jnp.asarray(loga[0, :, 0]
                                                           [None]))))


def test_ssd_scan_runs_the_intra_chunk_term_through_ops(monkeypatch):
    """ssd_scan's y_diag is ops.ssd_chunk on the (B·c, q, H, ·) view of
    the chunks, float32 operands, Bm/Cm broadcast without a copy."""
    calls = []
    real = tops.ssd_chunk

    def spy(xdt, loga, Bm, Cm):
        calls.append((tuple(xdt.shape), xdt.dtype, Bm.stride(2)))
        return real(xdt, loga, Bm, Cm)

    monkeypatch.setattr(tops, "ssd_chunk", spy)
    xdt, loga, Bm, Cm, _ = scan_inputs(2, 64, 4, 8, 1, 6, seed=8)
    ssm.ssd_scan(t(xdt).to(torch.bfloat16), t(loga), t(Bm), t(Cm), 16)
    assert calls == [((8, 16, 4, 8), torch.float32, 0)]


def test_decode_equals_full_forward():
    """Within the port (float32): prefill, then decode through the
    constant-size cache, gives the full forward's logits."""
    cfg = tconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    model = ssm.init(cfg, seed=5, device="cpu")
    toks = t(tokens_for(cfg.vocab, 2, 40, 5))
    full = f32(ssm.forward(cfg, model, toks))
    lg, cache = ssm.prefill(cfg, model, toks[:, :33])
    got = [f32(lg)[:, 0]]
    for i in range(33, 40):
        lg, cache = ssm.serve_step(cfg, model, cache, toks[:, i:i + 1])
        got.append(f32(lg)[:, 0])
    np.testing.assert_allclose(np.stack(got, 1), full[:, 32:], atol=1e-5,
                               rtol=1e-5)
    empty = ssm.init_decode_cache(cfg, 2, 10 ** 6, device="cpu")
    assert empty["state"].shape == cache["state"].shape


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_jax(get):
    assert dataclasses.asdict(getattr(tconfigs, get)(ARCH)) \
        == dataclasses.asdict(getattr(jconfigs, get)(ARCH))
    assert tmodels.count_params(getattr(tconfigs, get)(ARCH)) \
        == jmodels.count_params(getattr(jconfigs, get)(ARCH))


def test_full_size():
    """The size the H100 serves: 48 layers of 64 heads x 64, state 128."""
    cfg = tconfigs.get_config(ARCH)
    d_inner, H, P, G, N = ssm._dims(cfg)
    assert (cfg.n_layers, d_inner, H, P, G, N, cfg.ssm.chunk) \
        == (48, 4096, 64, 64, 1, 128, 256)
    assert round(tmodels.count_params(cfg) / 1e9, 2) == 1.34


def test_converter_round_trip_and_refusals():
    jcfg = jconfigs.get_smoke_config(ARCH)                 # bf16
    params = jax_params(jcfg, seed=3)
    cfg = tconfigs.get_smoke_config(ARCH)
    model = convert.params_from_numpy(cfg, params, "cpu")
    for lname, la in params["layers"].items():
        for li in range(cfg.n_layers):
            np.testing.assert_array_equal(
                model.leaf(lname, li).view(torch.int16).numpy(),
                la[li].view(np.int16))
    bad = dict(params, layers=dict(params["layers"]))
    bad["layers"]["A_log"] = bad["layers"]["A_log"][:1]
    with pytest.raises(ValueError, match="A_log"):
        convert.params_from_numpy(cfg, bad, "cpu")
    bad["layers"] = dict(params["layers"], extra=params["layers"]["D"])
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(cfg, bad, "cpu")


def test_serve_launcher_on_cpu(capsys):
    res = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                       "--prompt-len", "40", "--decode-steps", "3",
                       "--device", "cpu"])
    assert tuple(res.tokens.shape) == (2, 4)
    assert all(torch.isfinite(x).all() for x in res.step_logits)
    assert res.cache["next_pos"] == 43
    assert "ms/token" in capsys.readouterr().out
