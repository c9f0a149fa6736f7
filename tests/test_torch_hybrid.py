"""The port's RecurrentGemma / Griffin hybrid against the JAX package.

The recurrentgemma smoke model (one (rec, rec, attn) group, a 64-token
local window) in float32 gets the JAX package's initial parameters
through ``convert.params_from_numpy``; its ``forward`` and its
``prefill`` of an 80-token prompt (longer than the window, so the
window mask hides keys and the ring re-pack keeps the last 64 of them;
last-token logits and the whole cache) and four ``serve_step`` logits
are held against JAX's. The float32 tolerance is 1e-4 (absolute and
relative): both sides compute in float32 and differ only in the order
of their sums (the JAX RG-LRU takes an associative scan, the port a
sequential one). In bfloat16 the logits are held to 5e-2 of max|logit|:
bf16 keeps 8 significant bits and the two frameworks round activations
at different points. Also: the RG-LRU pieces, the layer layout, the
configs, the converter (``lam`` float32 in a bf16 model), decode
against the full forward within the port, and the launcher on the
CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import hybrid as jhybrid
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import convert, hybrid

ARCH = "recurrentgemma-9b"
F32_TOL = 1e-4
PROMPT, STEPS = 80, 4       # 80 > the smoke config's 64-token window


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
    """Logits and the whole cache: conv and h states of the two
    recurrent layers, and the ring of the attention layer's last 64
    keys and values with their positions."""
    cfg, model, toks, (jlogits, jcache), _, _ = f32_case
    logits, cache = port_prefill(cfg, model, toks)
    np.testing.assert_allclose(f32(logits), jlogits, atol=F32_TOL,
                               rtol=F32_TOL)
    for name in ("conv", "h", "k", "v"):
        assert cache[name].shape == jcache[name].shape, name
        np.testing.assert_allclose(f32(cache[name]), jcache[name],
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=name)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(), jcache["kv_pos"])
    assert sorted(cache["kv_pos"].tolist()) == list(range(PROMPT - 64,
                                                          PROMPT))
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
    params, toks, (jlogits, _), jsteps, jfwd = run_jax("bfloat16", seed=2)
    cfg = tconfigs.get_smoke_config(ARCH)
    assert cfg.dtype == "bfloat16"
    model = convert.params_from_numpy(cfg, params, "cpu")
    logits, cache = port_prefill(cfg, model, toks)
    assert cache["h"].dtype == torch.bfloat16         # as JAX keeps it
    got = [f32(logits)]
    for i in range(STEPS):
        lg, cache = tmodels.serve_step(cfg, model, cache,
                                       t(toks[:, PROMPT + i:PROMPT + i + 1]))
        got.append(f32(lg))
    got.append(f32(tmodels.forward(cfg, model, {"tokens": t(toks)})))
    for g, w in zip(got, [jlogits, *jsteps, jfwd]):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max()


def test_rg_lru_pieces_match_jax():
    """The block-diagonal gate product and the gates of one layer."""
    jcfg = jconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    cfg = tconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    params = jax_params(jcfg, seed=3)
    model = convert.params_from_numpy(cfg, params, "cpu")
    lp = jax.tree.map(lambda p: p[1], params["rec"])
    xc = np.random.default_rng(3).standard_normal((2, 5, 128), np.float32)
    np.testing.assert_allclose(
        f32(hybrid._block_diag_mm(t(xc), t(lp["w_a"]), t(lp["b_a"]))),
        f32(jhybrid._block_diag_mm(jnp.asarray(xc), lp["w_a"], lp["b_a"])),
        atol=1e-5, rtol=1e-5)
    log_a, b = model.layers[1].mixer._gates(t(xc))
    jlog_a, jb = jhybrid._rg_lru_gates(lp, jnp.asarray(xc))
    np.testing.assert_allclose(f32(log_a), f32(jlog_a), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(f32(b), f32(jb), atol=1e-6, rtol=1e-5)


def test_layer_layout_of_the_full_model():
    """38 layers: 12 groups of (rec, rec, attn) and a (rec, rec)
    remainder, 26 recurrent and 12 attention layers."""
    cfg = tconfigs.get_config(ARCH)
    assert hybrid.layer_layout(cfg) == jhybrid.layer_layout(
        jconfigs.get_config(ARCH)) == (12, ("rec", "rec"), 26, 12)
    kinds = hybrid.layer_kinds(cfg)
    assert kinds == ["rec", "rec", "attn"] * 12 + ["rec", "rec"]
    assert round(tmodels.count_params(cfg) / 1e9, 2) == 8.58


def test_decode_equals_full_forward():
    """Within the port (float32): prefill past the window, then decode
    through the ring cache, gives the full forward's logits."""
    cfg = tconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    model = hybrid.init(cfg, seed=5, device="cpu")
    toks = t(tokens_for(cfg.vocab, 2, 90, 5))
    full = f32(hybrid.forward(cfg, model, toks))
    lg, cache = hybrid.prefill(cfg, model, toks[:, :70])
    got = [f32(lg)[:, 0]]
    for i in range(70, 90):
        lg, cache = hybrid.serve_step(cfg, model, cache, toks[:, i:i + 1])
        got.append(f32(lg)[:, 0])
    np.testing.assert_allclose(np.stack(got, 1), full[:, 69:], atol=1e-5,
                               rtol=1e-5)
    empty = hybrid.init_decode_cache(cfg, 2, 10 ** 6, device="cpu")
    assert all(empty[k].shape == cache[k].shape
               for k in ("conv", "h", "k", "v", "kv_pos"))


def test_decode_from_an_empty_cache_matches_jax():
    """serve_step from init_decode_cache (a ring of min(window, context)
    slots) past the ring's wrap, against JAX's."""
    jcfg = jconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    cfg = tconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    params = jax_params(jcfg, seed=4)
    model = convert.params_from_numpy(cfg, params, "cpu")
    toks = tokens_for(cfg.vocab, 2, 12, 4)
    jcache = jmodels.init_decode_cache(jcfg, 2, 8)
    cache = tmodels.init_decode_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].shape == jcache["k"].shape
    for i in range(12):
        want, jcache = jmodels.serve_step(jcfg, params, jcache,
                                          jnp.asarray(toks[:, i:i + 1]))
        got, cache = tmodels.serve_step(cfg, model, cache, t(toks[:, i:i + 1]))
        np.testing.assert_allclose(f32(got), f32(want), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_jax(get):
    assert dataclasses.asdict(getattr(tconfigs, get)(ARCH)) \
        == dataclasses.asdict(getattr(jconfigs, get)(ARCH))
    assert tmodels.count_params(getattr(tconfigs, get)(ARCH)) \
        == jmodels.count_params(getattr(jconfigs, get)(ARCH))


def test_converter_keeps_per_leaf_types_and_refuses():
    """In a bf16 model ``rec.lam`` stays float32 (its ParamDef says so);
    every leaf arrives bit for bit; a wrong type or stack is refused."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    params = jax_params(jcfg, seed=6)
    assert str(params["rec"]["lam"].dtype) == "float32"
    cfg = tconfigs.get_smoke_config(ARCH)
    model = convert.params_from_numpy(cfg, params, "cpu")
    for stack in ("rec", "attn"):
        for lname, la in params[stack].items():
            for li in range(la.shape[0]):
                got = model.leaf(lname, li, stack)
                bits = np.int32 if got.dtype == torch.float32 else np.int16
                np.testing.assert_array_equal(
                    got.view(torch.int32 if bits is np.int32
                             else torch.int16).numpy(), la[li].view(bits))
    assert model.leaf("lam", 0, "rec").dtype == torch.float32
    assert model.leaf("w_x", 0, "rec").dtype == torch.bfloat16
    bad = dict(params, rec=dict(params["rec"]))
    bad["rec"]["lam"] = params["rec"]["lam"].astype(jnp.bfloat16)
    with pytest.raises(ValueError, match="lam"):
        convert.params_from_numpy(cfg, bad, "cpu")
    bad["rec"] = dict(params["rec"], w_out=params["rec"]["w_out"][:1])
    with pytest.raises(ValueError, match="w_out"):
        convert.params_from_numpy(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(cfg, {k: v for k, v in params.items()
                                        if k != "attn"}, "cpu")


def test_full_sequence_runs_the_recurrence_through_ops(monkeypatch):
    """Each recurrent layer's prefill takes its recurrence from
    ops.lru_scan, float32 a and b, no h0; decode does not call it."""
    calls = []
    real = tops.lru_scan

    def spy(a, b, h0=None):
        calls.append((tuple(a.shape), a.dtype, b.dtype, h0))
        return real(a, b, h0)

    monkeypatch.setattr(tops, "lru_scan", spy)
    cfg = tconfigs.get_smoke_config(ARCH)
    model = hybrid.init(cfg, seed=7, device="cpu")
    toks = t(tokens_for(cfg.vocab, 2, 20, 7))
    _, cache = hybrid.prefill(cfg, model, toks)
    assert calls == [((2, 20, 128), torch.float32, torch.float32, None)] * 2
    hybrid.serve_step(cfg, model, cache, toks[:, :1])
    assert len(calls) == 2


def test_serve_launcher_on_cpu(capsys):
    res = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                       "--prompt-len", "70", "--decode-steps", "3",
                       "--device", "cpu"])
    assert tuple(res.tokens.shape) == (2, 4)
    assert all(torch.isfinite(x).all() for x in res.step_logits)
    assert res.cache["next_pos"] == 73
    assert "ms/token" in capsys.readouterr().out
