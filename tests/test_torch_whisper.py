"""The port's whisper (the audio family) against the JAX package.

The whisper smoke model (2 encoder and 2 decoder layers over 24 stub
frames, d_model 128) in float32 gets the JAX package's initial
parameters through ``convert.params_from_numpy`` (the ``enc`` and
``dec`` stacks split into layers, the final LayerNorms unstacked);
``forward``, ``loss_fn``, and ``prefill`` (the last position's logits
and the whole cache, self and cross) with four ``serve_step``s are held
against JAX's at 1e-4 (absolute and relative: both sides compute in
float32 and differ only in the order of their sums), one jit of the
JAX model. Also the LayerNorm and the sinusoid table, the attention
routes (only the decoder's causal self-attention passes the kernel
hint), the configs, and ``make_batch``'s audio batch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.data import make_batch as jmake_batch
from repro.models import common as jcommon
from repro.models import whisper as jwhisper
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.data import make_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import attention, common, convert, whisper

ARCH = "whisper-large-v3"
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
    F = jcfg.encoder.n_frontend_tokens
    audio = (rng.standard_normal((2, F, jcfg.d_model)) * 0.3) \
        .astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)

    @jax.jit
    def run(p, a, tk):
        batch = {"audio_embeds": a, "tokens": tk}
        fwd = jmodels.forward(jcfg, p, batch)
        loss = jmodels.loss_fn(jcfg, p, batch)
        logits, cache = jmodels.prefill(
            jcfg, p, {"audio_embeds": a, "tokens": tk[:, :PROMPT]},
            pad_to=PROMPT + STEPS)
        pre_cache, steps = cache, []
        for i in range(STEPS):
            lg, cache = jmodels.serve_step(
                jcfg, p, cache, tk[:, PROMPT + i:PROMPT + i + 1])
            steps.append(lg)
        return fwd, loss, logits, pre_cache, steps

    want = jax.tree.map(np.asarray, run(params, jnp.asarray(audio),
                                        jnp.asarray(toks)))
    cfg = tconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    return cfg, convert.params_from_numpy(cfg, params, "cpu"), audio, toks, \
        want


def test_forward_matches_jax(f32_case):
    cfg, model, audio, toks, (jfwd, *_) = f32_case
    got = tmodels.forward(cfg, model, {"audio_embeds": t(audio),
                                       "tokens": t(toks)})
    np.testing.assert_allclose(f32(got), jfwd, atol=F32_TOL, rtol=F32_TOL)


def test_loss_matches_jax(f32_case):
    cfg, model, audio, toks, (_, jloss, *_) = f32_case
    loss = tmodels.loss_fn(cfg, model, {"audio_embeds": t(audio),
                                        "tokens": t(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), atol=F32_TOL,
                               rtol=F32_TOL)


def test_prefill_and_serve_steps_match_jax(f32_case):
    cfg, model, audio, toks, (_, _, jlogits, jcache, jsteps) = f32_case
    logits, cache = tmodels.prefill(
        cfg, model, {"audio_embeds": t(audio), "tokens": t(toks[:, :PROMPT])},
        pad_to=PROMPT + STEPS)
    np.testing.assert_allclose(f32(logits), jlogits, atol=F32_TOL,
                               rtol=F32_TOL)
    for name in ("k", "v", "cross_k", "cross_v"):
        assert tuple(cache[name].shape) == jcache[name].shape, name
        np.testing.assert_allclose(f32(cache[name]), jcache[name],
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=name)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(), jcache["kv_pos"])
    assert cache["next_pos"] == int(jcache["next_pos"]) == PROMPT
    for i, want in enumerate(jsteps):
        lg, cache = tmodels.serve_step(cfg, model, cache,
                                       t(toks[:, PROMPT + i:PROMPT + i + 1]))
        np.testing.assert_allclose(f32(lg), want, atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"step {i}")
    assert cache["next_pos"] == PROMPT + STEPS


def test_init_decode_cache_matches_jax():
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = tconfigs.get_smoke_config(ARCH)
    want = jmodels.init_decode_cache(jcfg, 3, 40)
    got = tmodels.init_decode_cache(cfg, 3, 40, device="cpu")
    assert sorted(got) == sorted(want)
    for name in ("k", "v", "cross_k", "cross_v", "kv_pos"):
        assert tuple(got[name].shape) == want[name].shape, name
        assert str(got[name].dtype).replace("torch.", "") \
            == str(want[name].dtype), name
    assert (got["kv_pos"] == -1).all() and got["next_pos"] == 0


def test_converter_splits_both_stacks():
    """Every leaf of a bfloat16 JAX tree, bit for bit: the enc and dec
    stacks split into their layers, the top-level leaves whole."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    params = jax.tree.map(np.asarray, jmodels.init(jcfg, jax.random.key(2)))
    model = convert.params_from_numpy(tconfigs.get_smoke_config(ARCH),
                                      params, "cpu")

    def bits(x):
        return x.view(torch.int16).numpy()

    for name, a in params.items():
        if isinstance(a, dict):
            for lname, la in a.items():
                for li in range(la.shape[0]):
                    np.testing.assert_array_equal(
                        bits(model.leaf(lname, li, name)),
                        la[li].view(np.int16), err_msg=f"{name}.{lname}")
        else:
            np.testing.assert_array_equal(bits(model.leaf(name)),
                                          a.view(np.int16), err_msg=name)


def test_layer_norm_and_sinusoid_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    g, b = rng.standard_normal((2, 64)).astype(np.float32)
    np.testing.assert_allclose(
        f32(common.layer_norm(t(x), t(g), t(b), 1e-5)),
        np.asarray(jcommon.layer_norm(jnp.asarray(x), g, b, 1e-5)),
        atol=1e-5, rtol=1e-5)
    xb = torch.from_numpy(x).bfloat16()
    got = common.layer_norm(xb, t(g), t(b), 1e-5)
    want = jcommon.layer_norm(jnp.asarray(x).astype(jnp.bfloat16), g, b, 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2, rtol=1e-2)
    for d in (2, 128, 1280):
        pos = np.arange(0, 1500, 7)
        np.testing.assert_allclose(
            f32(whisper._sinusoid(t(pos), d)),
            np.asarray(jwhisper._sinusoid(jnp.asarray(pos), d)),
            atol=2e-4, rtol=0)


def test_only_decoder_self_attention_passes_the_kernel_hint(monkeypatch):
    """The encoder's and the cross-attention's calls carry no hint (the
    plain path on any device), the decoder's self-attention over the
    prompt carries ``causal=True``; decode passes none."""
    cfg = tconfigs.get_smoke_config(ARCH).replace(dtype="float32")
    model = whisper.init(cfg, 0, device="cpu")
    calls = []
    attend = attention.attend

    def recording(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal")))
        return attend(q, k, v, **kw)

    monkeypatch.setattr(attention, "attend", recording)
    batch = make_batch(cfg, 2, 40, 0, 0, device="cpu")
    F = cfg.encoder.n_frontend_tokens
    S = batch["tokens"].shape[1]
    res = tserve.serve(cfg, model, batch, 2)
    enc, dec = cfg.encoder.n_layers, cfg.n_layers
    assert calls[:enc] == [(F, F, None)] * enc
    assert calls[enc:enc + 2 * dec] == [(S, S, True), (S, F, None)] * dec
    assert all(c[0] == 1 and c[2] is None for c in calls[enc + 2 * dec:])
    assert len(calls) == enc + 2 * dec + 2 * 2 * dec
    assert tuple(res.tokens.shape) == (2, 3)


def test_configs_and_param_count_match_jax():
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tconfigs, get)(ARCH)) \
            == dataclasses.asdict(getattr(jconfigs, get)(ARCH))
    n = tmodels.count_params(tconfigs.get_config(ARCH))
    assert n == jmodels.count_params(jconfigs.get_config(ARCH))
    assert round(n / 1e9, 3) == 1.536


@pytest.mark.parametrize("seq_len", [40, 12])
def test_audio_batch_shapes_types_and_repeats(seq_len):
    """Frame embeddings (B, F, d_model) in the model's type, normal x 0.3;
    max(seq_len - F, 8) decoder tokens, as the JAX pipeline makes them;
    the same batch for the same (seed, step), another for another step."""
    for dtype in ("bfloat16", "float32"):
        cfg = tconfigs.get_smoke_config(ARCH).replace(dtype=dtype)
        b = make_batch(cfg, 3, seq_len, 5, 2, device="cpu")
        want = jmake_batch(jconfigs.get_smoke_config(ARCH).replace(
            dtype=dtype), 3, seq_len, 5, 2)
        assert sorted(b) == sorted(want) == ["audio_embeds", "tokens"]
        for name in b:
            assert tuple(b[name].shape) == want[name].shape, name
            assert str(b[name].dtype).replace("torch.", "") \
                == str(want[name].dtype), name
        assert abs(float(b["audio_embeds"].float().std()) - 0.3) < 0.03
        again = make_batch(cfg, 3, seq_len, 5, 2, device="cpu")
        assert all(torch.equal(b[k], again[k]) for k in b)
        other = make_batch(cfg, 3, seq_len, 5, 3, device="cpu")
        assert not torch.equal(b["audio_embeds"], other["audio_embeds"])
