"""The port's dense LM against the JAX package.

For each of the four dense smoke configs in float32, the JAX package's
initial parameters are carried into the port with
``convert.params_from_numpy``, and the port's ``prefill`` (last-token
logits and the whole cache), four ``serve_step`` logits and ``forward``
logits are held against JAX's, with JAX's prefill on its Pallas flash
kernel (``REPRO_ATTN_IMPL=pallas``, interpret mode on the CPU). The
float32 tolerance is 1e-4 (absolute and relative): both sides compute
in float32 and differ only in the order of their sums. Also: the
config, parameter-count and data-pipeline copies, a bfloat16 model,
the converter, and decode through the cache (full and ring) against
the full forward within the port."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.data import make_batch
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import convert, dense

ARCHS = ["stablelm-12b", "command-r-35b", "mistral-large-123b",
         "nemotron-4-340b"]
F32_TOL = 1e-4
PROMPT, STEPS = 24, 4


def jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jmodels.init(jcfg, jax.random.key(seed)))


def tokens_for(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def port_cfg(arch, dtype):
    return tconfigs.get_smoke_config(arch).replace(dtype=dtype)


def run_jax(arch, dtype, seed):
    """JAX prefill (Pallas kernel) + STEPS decode steps + forward."""
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype=dtype)
    params = jax_params(jcfg, seed)
    toks = tokens_for(jcfg.vocab, 2, PROMPT + STEPS, seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_ATTN_IMPL", "pallas")
        logits, cache = jmodels.prefill(
            jcfg, params, {"tokens": jnp.asarray(toks[:, :PROMPT])},
            pad_to=PROMPT + STEPS)
        pre = (np.asarray(logits, np.float32),
               jax.tree.map(np.asarray, cache))
        steps = []
        for i in range(STEPS):
            lg, cache = jmodels.serve_step(
                jcfg, params, cache,
                jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]))
            steps.append(np.asarray(lg, np.float32))
        fwd = np.asarray(jmodels.forward(jcfg, params,
                                         {"tokens": jnp.asarray(toks)}),
                         np.float32)
    return params, toks, pre, steps, fwd


@pytest.fixture(scope="module", params=ARCHS)
def f32_case(request):
    arch = request.param
    params, toks, pre, steps, fwd = run_jax(arch, "float32", seed=1)
    cfg = port_cfg(arch, "float32")
    model = convert.params_from_numpy(cfg, params, "cpu")
    return cfg, model, toks, pre, steps, fwd


def port_prefill(cfg, model, toks):
    return tmodels.prefill(cfg, model,
                           {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                           pad_to=PROMPT + STEPS)


def f32(x):
    return x.float().numpy()


def test_prefill_matches_jax(f32_case):
    cfg, model, toks, (jlogits, jcache), _, _ = f32_case
    logits, cache = port_prefill(cfg, model, toks)
    assert tuple(logits.shape) == (2, 1, cfg.vocab)
    np.testing.assert_allclose(f32(logits), jlogits, atol=F32_TOL,
                               rtol=F32_TOL)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(f32(cache[name]), jcache[name],
                                   atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(), jcache["kv_pos"])
    assert cache["next_pos"] == int(jcache["next_pos"]) == PROMPT


def test_serve_steps_match_jax(f32_case):
    cfg, model, toks, _, jsteps, _ = f32_case
    _, cache = port_prefill(cfg, model, toks)
    for i, want in enumerate(jsteps):
        tok = torch.from_numpy(toks[:, PROMPT + i:PROMPT + i + 1])
        logits, cache = tmodels.serve_step(cfg, model, cache, tok)
        np.testing.assert_allclose(f32(logits), want, atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"step {i}")
    assert cache["next_pos"] == PROMPT + STEPS


def test_forward_matches_jax(f32_case):
    cfg, model, toks, _, _, jfwd = f32_case
    logits = tmodels.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(f32(logits), jfwd, atol=F32_TOL, rtol=F32_TOL)


def test_bf16_model_matches_jax():
    """stablelm smoke in bfloat16. Held to 3e-2 of max|logit|: bf16
    keeps 8 significant bits (a relative step of 2^-8), and the two
    frameworks round the activations at different points of each
    layer (matmul outputs, norms, rope), so the logits agree to a few
    bf16 steps, not to float32 precision."""
    arch = "stablelm-12b"
    params, toks, (jlogits, jcache), jsteps, jfwd = run_jax(arch, "bfloat16",
                                                            seed=2)
    cfg = port_cfg(arch, "bfloat16")
    model = convert.params_from_numpy(cfg, params, "cpu")
    logits, cache = port_prefill(cfg, model, toks)
    got = [f32(logits)]
    for i in range(STEPS):
        tok = torch.from_numpy(toks[:, PROMPT + i:PROMPT + i + 1])
        lg, cache = tmodels.serve_step(cfg, model, cache, tok)
        got.append(f32(lg))
    got.append(f32(tmodels.forward(cfg, model,
                                   {"tokens": torch.from_numpy(toks)})))
    for g, w in zip(got, [jlogits, *jsteps, jfwd]):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 3e-2 * np.abs(w).max()


def test_bf16_converter_round_trip():
    """bfloat16 leaves (ml_dtypes arrays) arrive bit for bit, each
    stacked leaf split into its layers."""
    jcfg = jconfigs.get_smoke_config("command-r-35b")      # tied, bf16
    params = jax_params(jcfg, seed=3)
    assert str(params["layers"]["wq"].dtype) == "bfloat16"
    model = convert.params_from_numpy(
        tconfigs.get_smoke_config("command-r-35b"), params, "cpu")

    def bits(t):
        return t.view(torch.int16).numpy()

    for name, a in params.items():
        if name == "layers":
            for lname, la in a.items():
                for li in range(jcfg.n_layers):
                    t = model.leaf(lname, li)
                    assert t.dtype == torch.bfloat16
                    np.testing.assert_array_equal(
                        bits(t), la[li].view(np.int16))
        else:
            np.testing.assert_array_equal(bits(model.leaf(name)),
                                          a.view(np.int16))
    assert not hasattr(model.top, "out_head")


def test_converter_refuses_mismatched_trees():
    cfg = tconfigs.get_smoke_config("stablelm-12b").replace(dtype="float32")
    params = jax_params(jconfigs.get_smoke_config("stablelm-12b")
                        .replace(dtype="float32"))
    bad = dict(params, layers=dict(params["layers"]))
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        convert.params_from_numpy(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(cfg, {k: v for k, v in params.items()
                                        if k != "out_head"}, "cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        convert.params_from_numpy(cfg.replace(dtype="bfloat16"), params,
                                  "cpu")


def test_ring_cache_decode_matches_jax():
    """Sliding-window decode from an empty ring cache (window 8) past
    the ring's wrap, against JAX's serve_step."""
    arch, S = "stablelm-12b", 12
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32", window=8)
    cfg = port_cfg(arch, "float32").replace(window=8)
    params = jax_params(jcfg, seed=4)
    model = convert.params_from_numpy(cfg, params, "cpu")
    toks = tokens_for(cfg.vocab, 2, S, 4)
    jcache = jmodels.init_decode_cache(jcfg, 2, 64)
    cache = tmodels.init_decode_cache(cfg, 2, 64, device="cpu")
    assert cache["k"].shape[2] == jcache["k"].shape[2] == 8
    for i in range(S):
        want, jcache = jmodels.serve_step(jcfg, params, jcache,
                                          jnp.asarray(toks[:, i:i + 1]))
        got, cache = tmodels.serve_step(cfg, model, cache,
                                        torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(f32(got), np.asarray(want), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(jcache["kv_pos"]))


@pytest.mark.parametrize("window", [0, 8])
def test_cache_decode_equals_full_forward(window):
    """Within the port: prefill, then decode through the cache (full,
    or a ring of the window size fed from an empty cache), gives the
    full forward's logits at every position (float32; only the order
    of the sums differs, so 1e-5)."""
    cfg = port_cfg("nemotron-4-340b", "float32").replace(window=window)
    model = dense.init(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(tokens_for(cfg.vocab, 2, 20, 5))
    full = f32(dense.forward(cfg, model, toks))
    if window:
        cache, start, got = dense.init_decode_cache(cfg, 2, 64,
                                                    device="cpu"), 0, []
    else:
        lg, cache = dense.prefill(cfg, model, toks[:, :12], pad_to=20)
        start, got = 12, [f32(lg)[:, 0]]
    for i in range(start, 20):
        lg, cache = dense.serve_step(cfg, model, cache, toks[:, i:i + 1])
        got.append(f32(lg)[:, 0])
    first = 11 if not window else 0
    np.testing.assert_allclose(np.stack(got, 1), full[:, first:],
                               atol=1e-5, rtol=1e-5)
    if not window:                 # 20 slots, all written
        with pytest.raises(IndexError, match="full"):
            dense.serve_step(cfg, model, cache, toks[:, :1])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        j = dataclasses.asdict(getattr(jconfigs, get)(arch))
        t = dataclasses.asdict(getattr(tconfigs, get)(arch))
        assert t == j
    assert tmodels.count_params(tconfigs.get_config(arch)) \
        == jmodels.count_params(jconfigs.get_config(arch))


def test_stablelm_full_size():
    """The size the H100 serves: 12.14 B parameters, 204,800 bytes of
    bf16 KV cache per token."""
    cfg = tconfigs.get_config("stablelm-12b")
    assert round(tmodels.count_params(cfg) / 1e9, 2) == 12.14
    assert 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2 == 204_800


def test_every_jax_arch_is_ported_or_names_its_item():
    """Every arch of the JAX package is ported: the same archs, each
    config (full and smoke) and its model family the JAX package's."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in jconfigs.list_archs():
        for get in ("get_config", "get_smoke_config"):
            assert dataclasses.asdict(getattr(tconfigs, get)(arch)) \
                == dataclasses.asdict(getattr(jconfigs, get)(arch))
        cfg = tconfigs.get_smoke_config(arch)
        assert tmodels.get_module(cfg).__name__.rsplit(".", 1)[1] \
            == jmodels.get_module(jconfigs.get_smoke_config(arch)) \
            .__name__.rsplit(".", 1)[1]


def test_init_draws_the_jax_distribution():
    """Leaf by leaf from a seeded generator: the JAX package's scales
    (1/sqrt(fan_in) of the stacked shape, 0.02 for the embedding, zero
    norm gains), reproducible from the seed."""
    cfg = port_cfg("stablelm-12b", "float32").replace(n_layers=4)
    m = dense.init(cfg, seed=6, device="cpu")
    L, D, H = cfg.n_layers, cfg.d_model, cfg.n_heads
    assert abs(m.leaf("embed").std().item() / 0.02 - 1) < 0.02
    for name, fan_in in (("wq", L * D * H), ("w_down", L * cfg.d_ff),
                         ("wo", L * H * cfg.head_dim)):
        std = torch.stack([m.leaf(name, li) for li in range(L)]).std().item()
        assert abs(std * math.sqrt(fan_in) - 1) < 0.05, name
    assert not m.leaf("attn_norm", 2).any()
    assert not any(p.requires_grad for p in m.parameters())
    again = dense.init(cfg, seed=6, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                  again.parameters()))
    assert not torch.equal(m.leaf("wq", 0), m.leaf("wq", 1))


def test_make_batch_zipf_tokens():
    cfg = port_cfg("stablelm-12b", "float32")
    b = make_batch(cfg, 64, 512, seed=0, step=0, device="cpu")["tokens"]
    assert b.dtype == torch.int32 and tuple(b.shape) == (64, 512)
    assert 0 <= int(b.min()) and int(b.max()) < cfg.vocab
    assert torch.equal(b, make_batch(cfg, 64, 512, 0, 0,
                                     device="cpu")["tokens"])
    assert not torch.equal(b, make_batch(cfg, 64, 512, 0, 1,
                                         device="cpu")["tokens"])
    # P(token 0) = P(u < log 2 / log V) under the inverse-CDF rule
    p0 = math.log(2.0) / math.log(cfg.vocab)
    assert abs((b == 0).float().mean().item() - p0) < 0.01
    counts = torch.bincount(b.flatten().long(), minlength=cfg.vocab)
    assert counts[0] > counts[1] > counts[10] > counts[100]


def test_serve_launcher_on_cpu(capsys):
    res = tserve.main(["--arch", "mistral-large-123b", "--smoke", "--batch",
                       "3", "--prompt-len", "16", "--decode-steps", "5",
                       "--device", "cpu"])
    cfg = tconfigs.get_smoke_config("mistral-large-123b")
    assert tuple(res.tokens.shape) == (3, 6)
    assert len(res.step_logits) == 5
    assert tuple(res.prefill_logits.shape) == (3, 1, cfg.vocab)
    assert all(torch.isfinite(x).all() for x in res.step_logits)
    assert res.cache["next_pos"] == 21
    assert "ms/token" in capsys.readouterr().out


def test_serve_path_on_cpu_launches_no_kernel():
    cfg = port_cfg("stablelm-12b", "float32")
    model = dense.init(cfg, seed=7, device="cpu")
    before = dict(tops.LAUNCHES)
    res = tserve.serve(cfg, model, {"tokens": torch.from_numpy(
        tokens_for(cfg.vocab, 2, 16, 7))}, 3)
    assert tops.LAUNCHES == before
    assert res.tokens.dtype == torch.int32
    # greedy: each token is the argmax of the logits before it
    assert torch.equal(res.tokens[:, 0], res.prefill_logits[:, -1]
                       .argmax(-1).to(torch.int32))
    for i, lg in enumerate(res.step_logits):
        assert torch.equal(res.tokens[:, i + 1],
                           lg[:, -1].argmax(-1).to(torch.int32))


def test_rms_norm_and_rope_match_jax():
    from repro.models import common as jcommon
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 4, 16), np.float32)
    g = rng.standard_normal(16, np.float32) * 0.1
    pos = np.arange(6, dtype=np.int32) + 1000
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
        .numpy(), np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g),
                                              1e-5)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=2e-5, rtol=2e-5)
    for kind in ("silu", "gelu", "sq_relu"):
        np.testing.assert_allclose(
            tcommon.activate(torch.from_numpy(x), kind).numpy(),
            np.asarray(jcommon.activate(jnp.asarray(x), kind)),
            atol=1e-6, rtol=1e-5, err_msg=kind)
