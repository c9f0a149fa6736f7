"""The port's training slice against the JAX package: AdamW, the losses
of every family (dense, ssm, hybrid, moe, vlm, audio) and their
gradients, the train step, the checkpoint and the train launcher, on
the CPU at smoke size.

Both packages start from the same numbers: the JAX package's initial
train state (``repro.trainer.init_train_state``), as numpy, carried into
the port by ``convert.train_state_from_numpy``; batches are numpy
tokens from a seed, and for the vlm and audio families numpy normals
(times 0.3, as ``make_batch`` scales them) for their patch or frame
embeddings. Tolerances, float32: AdamW within 1e-6 of each
leaf's largest magnitude (both sides round the same f32 operations; XLA
may fuse a multiply-add); the loss within 1e-5 relative and each
gradient within 1e-4 of its own largest magnitude (the two sum matrix
products in other orders); three train steps' losses within 1e-5
relative and each parameter leaf within 1e-5 of its norm
(||p - p_jax|| / ||p_jax||). Elementwise, AdamW's g / (sqrt(v) + eps)
turns the f32 disagreement of a gradient entry near zero (a few 1e-7
of its leaf's largest) into a parameter difference of up to the
learning rate: one of the 65,536 embedding entries differs by 1.7e-5
after three steps at lr 1e-3, its first gradient 5.10e-7 in JAX and
5.45e-7 in the port. bfloat16 moments within one bf16 step of JAX's; a
bf16 model's loss at 5e-2 (its products round at other points)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import trainer as jtrainer
from repro.checkpoint import estimate_grace_period as jgrace
from repro.checkpoint import save_pytree as jsave
from repro.checkpoint import state_bytes as jbytes
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import trainer as ttrainer
from repro_torch import tree as ttree
from repro_torch.checkpoint import (estimate_grace_period, load_pytree,
                                    load_tree, save_pytree, state_bytes)
from repro_torch.launch import train as ttrain
from repro_torch.models import convert, dense
from repro_torch.optim import adamw as tadamw
from torch_threads import one_thread  # noqa: F401

ARCHS = ["stablelm-12b", "command-r-35b", "nemotron-4-340b"]


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# -- AdamW on random trees ---------------------------------------------------

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}, "e": (64,)}


def rand_tree(rng, scale=1.0, positive=False):
    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        x = rng.standard_normal(node).astype(np.float32) * scale
        return np.abs(x) if positive else x
    return go(SHAPES)


def t_tree(tree, dtype=torch.float32):
    return {k: t_tree(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def j_tree(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def pairs(port_tree, jax_tree):
    want = {tuple(str(getattr(p, "key", p)) for p in path): np.asarray(
        leaf, np.float32) for path, leaf in
        jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    got = dict(ttree.flatten(port_tree))
    assert set(got) == set(want)
    return [(to_np(got[k]), want[k], k) for k in want]


OPT_CASES = {
    "default": dict(warmup_steps=2, total_steps=10),
    "clip_active": dict(grad_clip=0.05, warmup_steps=2, total_steps=10),
    "no_clip_no_decay": dict(grad_clip=0.0, weight_decay=0.0,
                             warmup_steps=0, total_steps=10),
}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(OPT_CASES))
@pytest.mark.parametrize("step", [0, 4])
def test_adamw_update_matches_jax(case, moments, step):
    rng = np.random.default_rng([sum(map(ord, case + moments)), step])
    p, g = rand_tree(rng), rand_tree(rng, 0.1)
    m, v = rand_tree(rng, 0.01 * (step > 0)), \
        rand_tree(rng, 1e-3 * (step > 0), positive=True)
    kw = dict(lr=1e-2, moment_dtype=moments, **OPT_CASES[case])
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    mdt_j = jnp.dtype(moments)
    mdt_t = torch.bfloat16 if moments == "bfloat16" else torch.float32
    jp, jopt = jadamw.adamw_update(
        j_tree(g), {"m": j_tree(m, mdt_j), "v": j_tree(v, mdt_j),
                    "step": jnp.asarray(step, jnp.int32)}, j_tree(p), jcfg)
    tp, topt = tadamw.adamw_update(
        t_tree(g), {"m": t_tree(m, mdt_t), "v": t_tree(v, mdt_t),
                    "step": torch.tensor(step, dtype=torch.int32)},
        t_tree(p), tcfg)
    assert topt["step"].dtype == torch.int32
    assert int(topt["step"]) == int(jopt["step"]) == step + 1
    for got, want, k in pairs(tp, jp):
        assert rel_err(got, want) <= 1e-6, k
    for name in ("m", "v"):
        for got, want, k in pairs(topt[name], jopt[name]):
            assert dict(ttree.flatten(topt[name]))[k].dtype == mdt_t
            if moments == "float32":
                assert rel_err(got, want) <= 1e-6, (name, k)
            else:   # one bf16 step: 2^-7 of the value's binade
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(want), 1e-30))) - 7)
                assert np.all(np.abs(got - want) <= ulp), (name, k)


def test_cosine_schedule_and_global_norm_match_jax():
    cfg = dict(lr=3e-3, warmup_steps=3, total_steps=12)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    for s in range(0, 15):
        want = float(jadamw.cosine_schedule(jcfg, jnp.asarray(s, jnp.int32)))
        got = float(tadamw.cosine_schedule(
            tcfg, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), s
    tree = rand_tree(np.random.default_rng(3))
    want = float(jadamw.global_norm(j_tree(tree)))
    assert rel_err(float(tadamw.global_norm(t_tree(tree))), want) <= 1e-6


def test_adamw_init_shapes_and_step_type():
    p = t_tree(rand_tree(np.random.default_rng(0)))
    st = tadamw.adamw_init(p, tadamw.AdamWConfig(moment_dtype="bfloat16"))
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    for (path, a), (_, m) in zip(ttree.flatten(p), ttree.flatten(st["m"])):
        assert m.shape == a.shape and m.dtype == torch.bfloat16
        assert not m.any()


# -- the dense loss and its gradients ----------------------------------------

def tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def batch_np(cfg, B, S, seed):
    """A numpy batch: ``tokens(cfg.vocab, B, S, seed)``, and for the vlm
    and audio families their stub embeddings from the same generator,
    (B, n_visual, d_visual) or (B, frames, d_model) normals times 0.3."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        shape, key = (B, cfg.vlm.n_visual_tokens, cfg.vlm.d_visual), \
            "visual_embeds"
    elif cfg.family == "audio":
        shape, key = (B, cfg.encoder.n_frontend_tokens, cfg.d_model), \
            "audio_embeds"
    else:
        return out
    out[key] = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return out


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_state(arch, dtype="float32", moments="float32", seed=0, **opt):
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype=dtype)
    ocfg = jadamw.AdamWConfig(moment_dtype=moments, **opt)
    return jcfg, ocfg, jtrainer.init_train_state(jcfg, ocfg,
                                                 jax.random.key(seed))


def port_state(arch, jstate, dtype="float32"):
    cfg = tconfigs.get_smoke_config(arch).replace(dtype=dtype)
    return cfg, convert.train_state_from_numpy(cfg, np_tree(jstate), "cpu")


def param_pairs(model, jtree):
    """(port tensor, JAX numpy leaf, name) for every parameter, stacked
    JAX leaves split by layer: each stack of the family (``layers``, the
    moe's expert stacks among them; the hybrid's ``rec`` and ``attn``;
    whisper's ``enc`` and ``dec``); a dict whose leaves are not stacked
    (vlm's ``projector``) leaf for leaf."""
    defs = tmodels.get_module(model.cfg).param_defs(model.cfg)
    out = []
    for name, a in jtree.items():
        if isinstance(a, dict):
            for lname, la in a.items():
                if not dense.is_stacked(defs[name][lname]):
                    out.append((model.leaf(lname, None, name),
                                np.asarray(la, np.float32),
                                f"{name}.{lname}"))
                    continue
                for li in range(la.shape[0]):
                    out.append((model.leaf(lname, li, name),
                                np.asarray(la[li], np.float32),
                                f"{name}.{lname}[{li}]"))
        else:
            out.append((model.leaf(name), np.asarray(a, np.float32), name))
    return out


def loss_and_grads_against_jax(arch, jit=False):
    jcfg, _, js = jax_state(arch)
    cfg, st = port_state(arch, js)
    b = batch_np(cfg, 2, 24, 5)
    vg = jax.value_and_grad(lambda p: jmodels.loss_fn(jcfg, p, jbatch(b)))
    jloss, jgrads = (jax.jit(vg) if jit else vg)(js["params"])
    model = st["params"]
    loss = tmodels.loss_fn(cfg, model, tbatch(b))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert rel_err(float(loss.detach()), float(jloss)) <= 1e-5
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    names = {id(p): n for n, p in model.named_parameters()}
    pp = param_pairs(model, np_tree(jgrads))
    assert len(pp) == len(grads)
    for p, want, name in pp:
        assert rel_err(to_np(grads[names[id(p)]]), want) <= 1e-4, name
    if cfg.family == "moe":      # the router learns, through p alone
        for li in range(cfg.n_layers):
            g = grads[names[id(model.leaf("w_router", li))]]
            assert float(g.abs().max()) > 0, li


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_loss_and_grads_match_jax(arch):
    loss_and_grads_against_jax(arch)


# the families past the dense one: ssm, hybrid, then moe, vlm and audio
FAMILY_ARCHS = ["mamba2-1.3b", "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                "mixtral-8x22b", "internvl2-2b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_ssm_and_hybrid_loss_and_grads_match_jax(arch):
    """The training routes of the families past the dense one against
    JAX's ``loss_fn`` and gradients, float32: the loss within 1e-5
    relative and each gradient within 1e-4 of its largest magnitude, as
    the dense family's. The ssm's plain intra-chunk term and the
    hybrid's sequential RG-LRU (which autograd differentiates on the
    CPU) against JAX's jnp ``y_diag`` and associative scan (the scans
    differ only in the order of their products and sums); the moe's
    routed layer under remat, its load-balance loss included (every
    layer's ``w_router`` gets a nonzero gradient); the vlm's text-only
    loss after its projected visual prefix (the projector's gradient);
    whisper's encoder and decoder stacks and its tied unembedding."""
    loss_and_grads_against_jax(arch, jit=True)


# -- the train step ----------------------------------------------------------

def run_steps(step_fn, state, batches):
    losses = []
    for b in batches:
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
    return state, losses, int(m["step"])


def three_steps_against_jax(arch, dtype, tol, param_tol=1e-5):
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg, jocfg, js = jax_state(arch, dtype, **opt)
    cfg, st = port_state(arch, js, dtype)
    batches = [batch_np(cfg, 4, 32, 10 + i) for i in range(3)]
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jocfg))
    js, jlosses, jn = run_steps(jstep, js, [jbatch(b) for b in batches])
    st, losses, n = run_steps(
        ttrainer.make_train_step(cfg, tadamw.AdamWConfig(**opt)), st,
        [tbatch(b) for b in batches])
    assert n == jn == 3 and int(st["opt"]["step"]) == 3
    for got, want in zip(losses, jlosses):
        assert rel_err(got, want) <= tol, (losses, jlosses)
    if dtype == "float32":
        for p, want, name in param_pairs(st["params"],
                                         np_tree(js["params"])):
            err = np.linalg.norm(to_np(p) - want) / np.linalg.norm(want)
            assert err <= param_tol, (name, err)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
def test_three_train_steps_match_jax(dtype, tol):
    three_steps_against_jax("stablelm-12b", dtype, tol)


# the hybrid's float32 parameters after three steps: 5e-5 of each leaf's
# norm. Its RG-LRU gradients differ from JAX's associative scan by the
# order of the scan's products and sums (within 1e-4 of each gradient's
# largest, as the dense family's), and AdamW turns a gradient entry near
# zero into up to lr of parameter; the leaves that start at zero (norm
# gains, gate biases) hold only three steps' updates, so one such entry
# is a visible share of their norm (rec.norm[0] 1.3e-5, attn.mlp_norm[0]
# 1.4e-5 of it in this sandbox; every other leaf below 1e-5). Whisper's
# likewise: its zero-initialised bias ``dec.cross_bv[1]`` reads 3.0e-5 of
# its norm (its gradient is the sum over the batch's positions of the
# cross-attention output's gradient, whose terms nearly cancel), every
# other leaf below 3.1e-6
PARAM_TOL = {"mamba2-1.3b": 1e-5, "recurrentgemma-9b": 5e-5,
             "qwen3-moe-30b-a3b": 1e-5, "mixtral-8x22b": 1e-5,
             "internvl2-2b": 1e-5, "whisper-large-v3": 5e-5}


@pytest.mark.parametrize("arch,dtype,tol", [
    ("mamba2-1.3b", "float32", 1e-5),
    ("recurrentgemma-9b", "float32", 1e-5),
    ("recurrentgemma-9b", "bfloat16", 5e-2),
    ("qwen3-moe-30b-a3b", "float32", 1e-5),
    ("mixtral-8x22b", "float32", 1e-5),
    ("internvl2-2b", "float32", 1e-5),
    ("whisper-large-v3", "float32", 1e-5),
    ("qwen3-moe-30b-a3b", "bfloat16", 5e-2)])
def test_ssm_and_hybrid_three_train_steps_match_jax(dtype, tol, arch):
    """Three train steps of a family past the dense one against JAX's
    jitted train step on the same state: the losses within 1e-5 (f32)
    or 5e-2 (bf16) relative, the f32 parameters within
    :data:`PARAM_TOL`. Two bf16 cases: the hybrid's (its float32 ``lam``
    beside bfloat16 leaves) and qwen3-moe's (its router's bf16 logits
    round at other points, so a route may differ)."""
    three_steps_against_jax(arch, dtype, tol, PARAM_TOL[arch])


@pytest.mark.parametrize("arch", ["stablelm-12b", "internvl2-2b"])
def test_microbatch_equivalence(arch):
    """grad accumulation over 2 microbatches == the full-batch step (the
    JAX suite's ``TestTrainer`` case, on the port); internvl2's batch
    splits its visual embeddings with its tokens."""
    jcfg, _, js = jax_state(arch)
    ocfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                              grad_clip=0.0)
    batch = tbatch(batch_np(tconfigs.get_smoke_config(arch), 4, 32, 0))
    out = []
    for mb in (1, 2):
        cfg, st = port_state(arch, js)
        st, m = ttrainer.make_train_step(cfg, ocfg, mb)(st, batch)
        out.append((float(m["loss"]), st["params"]))
    assert abs(out[0][0] - out[1][0]) <= 1e-5
    for (n, a), (_, b) in zip(out[0][1].named_parameters(),
                              out[1][1].named_parameters()):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=2e-5,
                                   err_msg=n)
    with pytest.raises(ValueError, match="microbatches"):
        ttrainer.make_train_step(cfg, ocfg, 3)(st, batch)


def test_remat_modes_give_equal_grads():
    """none, full and dots recompute the same float32 operations, so the
    gradients agree bit for bit."""
    arch = "stablelm-12b"
    _, _, js = jax_state(arch)
    batch = {"tokens": torch.from_numpy(tokens(512, 2, 24, 1))}
    grads = {}
    for remat in ("none", "full", "dots"):
        cfg, st = port_state(arch, js)
        cfg = cfg.replace(remat=remat)
        model = st["params"]
        loss = tmodels.loss_fn(cfg, model, batch)
        grads[remat] = (float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters())))
    for remat in ("full", "dots"):
        assert grads[remat][0] == grads["none"][0]
        for a, b in zip(grads[remat][1], grads["none"][1]):
            assert torch.equal(a, b), remat
    with pytest.raises(ValueError, match="remat"):
        tmodels.loss_fn(cfg.replace(remat="some"), model, batch)


def test_grad_clip_matches_jax():
    """A tiny clip barely moves the parameters (the JAX suite's case) and
    moves them as JAX does."""
    arch = "stablelm-12b"
    opt = dict(lr=1e-2, grad_clip=1e-6, weight_decay=0.0, warmup_steps=0,
               total_steps=10)
    jcfg, jocfg, js = jax_state(arch, **opt)
    cfg, st = port_state(arch, js)
    before = {n: p.detach().clone() for n, p in
              st["params"].named_parameters()}
    toks = tokens(cfg.vocab, 2, 16, 0)
    jnew, _ = jtrainer.make_train_step(jcfg, jocfg)(
        js, {"tokens": jnp.asarray(toks)})
    st, _ = ttrainer.make_train_step(cfg, tadamw.AdamWConfig(**opt))(
        st, {"tokens": torch.from_numpy(toks)})
    delta = max(float((p.detach() - before[n]).abs().max())
                for n, p in st["params"].named_parameters())
    assert 0 < delta < 1e-2
    for p, want, name in param_pairs(st["params"], np_tree(jnew["params"])):
        np.testing.assert_allclose(to_np(p), want, atol=1e-6, err_msg=name)


def test_kernel_path_is_not_the_training_route(monkeypatch):
    """The train step reaches attend's plain path by leaving out the
    kernel hints, not by a grad-mode test inside attend."""
    from repro_torch.models import attention
    seen = []
    attend = attention.attend

    def spy(q, k, v, **kw):
        seen.append(kw.get("causal"))
        return attend(q, k, v, **kw)

    monkeypatch.setattr(attention, "attend", spy)
    cfg = tconfigs.get_smoke_config("stablelm-12b").replace(dtype="float32")
    st = ttrainer.init_train_state(cfg, tadamw.AdamWConfig(), 0,
                                   device="cpu")
    batch = {"tokens": torch.from_numpy(tokens(512, 2, 16, 0))}
    tmodels.loss_fn(cfg, st["params"], batch)
    assert seen == [None] * cfg.n_layers
    seen.clear()
    tmodels.forward(cfg, st["params"], batch)
    assert seen == [True] * cfg.n_layers


# -- checkpoints -------------------------------------------------------------

def test_checkpoint_roundtrip_bf16(tmp_path):
    """bf16 parameters and moments come back bit for bit, each leaf with
    its type (the JAX suite's ``TestCheckpoint`` case)."""
    cfg = tconfigs.get_smoke_config("command-r-35b")
    ocfg = tadamw.AdamWConfig(moment_dtype="bfloat16")
    st = ttrainer.init_train_state(cfg, ocfg, 1, device="cpu")
    st, _ = ttrainer.make_train_step(cfg, ocfg)(
        st, {"tokens": torch.from_numpy(tokens(cfg.vocab, 2, 16, 0))})
    path = str(tmp_path / "ck.npz")
    n = save_pytree(st, path)
    assert n == os.path.getsize(path) >= state_bytes(st)
    other = ttrainer.init_train_state(cfg, ocfg, 2, device="cpu")
    back = load_pytree(other, path)
    assert back is other
    a, b = dict(ttree.flatten(st)), dict(ttree.flatten(back))
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        assert torch.equal(a[k], b[k]), k
    assert a[("params", "top.embed")].dtype == torch.bfloat16
    assert a[("opt", "m", "top.embed")].dtype == torch.bfloat16
    with np.load(path) as data:          # a plain .npz, as np.savez writes
        assert "__meta__" in data.files
    bad = ttrainer.init_train_state(cfg, tadamw.AdamWConfig(), 0,
                                    device="cpu")
    with pytest.raises(ValueError, match="template"):
        load_pytree(bad, path)           # float32 moments in the template


# one arch of each family past the dense one
CKPT_ARCHS = ["mamba2-1.3b", "recurrentgemma-9b", "qwen3-moe-30b-a3b",
              "internvl2-2b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_checkpoint_roundtrip_ssm_and_hybrid(tmp_path, arch):
    """A stepped bf16 state of a family past the dense one comes back bit
    for bit, each leaf with its type: the hybrid's float32 ``lam``
    beside bfloat16 leaves and its two stacks, the moe's expert stacks,
    the vlm's unstacked ``projector``, whisper's ``enc`` and ``dec``."""
    cfg = tconfigs.get_smoke_config(arch)
    ocfg = tadamw.AdamWConfig(moment_dtype="bfloat16")
    st = ttrainer.init_train_state(cfg, ocfg, 1, device="cpu")
    st, _ = ttrainer.make_train_step(cfg, ocfg)(
        st, tbatch(batch_np(cfg, 2, 16, 0)))
    path = str(tmp_path / "ck.npz")
    save_pytree(st, path)
    back = load_pytree(ttrainer.init_train_state(cfg, ocfg, 2,
                                                 device="cpu"), path)
    a, b = dict(ttree.flatten(st)), dict(ttree.flatten(back))
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    if cfg.family == "hybrid":
        lam = [k for k in a if k[0] == "params" and k[-1].endswith(".lam")]
        assert lam and all(a[k].dtype == torch.float32 for k in lam)
        assert a[("opt", "m") + lam[0][1:]].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_train_state_from_numpy_carries_ssm_and_hybrid(arch):
    """JAX's bf16 state with bf16 moments converts with every value in
    place: the hybrid's ``rec``/``attn`` stacks split into the right
    layers, ``lam`` float32 beside its bfloat16 moments; the moe's
    expert stacks, the vlm's ``projector`` (not a stack) and whisper's
    ``enc``/``dec`` stacks, parameters and moments alike."""
    _, _, js = jax_state(arch, "bfloat16", "bfloat16", seed=3)
    cfg = tconfigs.get_smoke_config(arch)
    st = convert.train_state_from_numpy(cfg, np_tree(js), "cpu")
    model = st["params"]
    names = {id(p): n for n, p in model.named_parameters()}
    jnp_state = np_tree(js)
    for p, want, name in param_pairs(model, jnp_state["params"]):
        assert p.requires_grad and np.array_equal(to_np(p), want), name
        if name.endswith(".lam") or ".lam[" in name:
            assert p.dtype == torch.float32
    for mom in ("m", "v"):
        for p, want, name in param_pairs(model, jnp_state["opt"][mom]):
            got = st["opt"][mom][names[id(p)]]
            assert got.dtype == torch.bfloat16 and got.shape == p.shape
            assert np.array_equal(to_np(got), want), (mom, name)
    assert state_bytes(st) == jbytes(js)


def ckpt_tree():
    """A tree of every kind of leaf a train state holds: float32,
    bfloat16, a 0-d int32 step, an empty leaf, a non-ASCII key."""
    rng = np.random.default_rng(7)
    return {"params": {
        "w§x": torch.from_numpy(rng.standard_normal((37, 51))
                                .astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
        .to(torch.bfloat16)},
        "opt": {"step": torch.tensor(3, dtype=torch.int32),
                "e": torch.empty(0, 4)}}


def test_checkpoint_file_is_np_savez_byte_for_byte(tmp_path, monkeypatch):
    """The pipelined writer, its chunks cut small so every leaf spans
    several written by concurrent threads (switching often), writes the
    bytes ``np.savez`` writes for the same arrays (JAX's ``save_pytree``
    layout: ``__meta__`` first, bfloat16 as uint16); the reader restores
    them, and a flipped data byte raises."""
    import json
    import sys
    import zipfile
    from repro_torch.checkpoint import ckpt
    monkeypatch.setattr(ckpt, "_CHUNK", 1000)
    tree = ckpt_tree()
    port, ref = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        save_pytree(tree, port)
    finally:
        sys.setswitchinterval(interval)
    flat = dict(ttree.flatten(tree))
    packed = {"§".join(k): (t.view(torch.int16).numpy().view(np.uint16)
                            if t.dtype == torch.bfloat16 else t.numpy())
              for k, t in flat.items()}
    meta = {k: "bfloat16" for k, a in packed.items() if a.dtype == np.uint16}
    np.savez(ref, __meta__=json.dumps(meta), **packed)
    with open(port, "rb") as a, open(ref, "rb") as b:
        data = a.read()
        assert data == b.read()
    back = {"params": {"w§x": torch.zeros(37, 51),
                       "b": torch.zeros(1000, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32),
                    "e": torch.empty(0, 4)}}
    load_pytree(back, port)
    for k, t in dict(ttree.flatten(back)).items():
        assert t.dtype == flat[k].dtype and torch.equal(t, flat[k]), k
    with zipfile.ZipFile(port) as zf:
        info = zf.getinfo("params§w§x.npy")
    bad = bytearray(data)
    bad[info.header_offset + info.compress_size] ^= 1   # inside the data
    with open(port, "wb") as f:
        f.write(bad)
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        load_pytree(back, port)


def test_jax_load_pytree_reads_a_port_checkpoint(tmp_path):
    """JAX's ``load_pytree`` restores a file the port wrote into a JAX
    template of the same tree, every leaf equal (bfloat16 included)."""
    from repro.checkpoint import load_pytree as jload
    tree = ckpt_tree()
    path = str(tmp_path / "port.npz")
    save_pytree(tree, path)
    jtree = {"params": {"w§x": jnp.zeros((37, 51), jnp.float32),
                        "b": jnp.zeros((1000,), jnp.bfloat16)},
             "opt": {"step": jnp.zeros((), jnp.int32),
                     "e": jnp.zeros((0, 4), jnp.float32)}}
    back = jload(jtree, path)
    for k, t in dict(ttree.flatten(tree)).items():
        got = back[k[0]][k[1]]
        assert got.dtype == jtree[k[0]][k[1]].dtype
        assert np.array_equal(np.asarray(got, np.float32), to_np(t)), k


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-12b", "command-r-35b"])
def test_state_bytes_and_grace_period_match_jax(arch, moments):
    _, _, js = jax_state(arch, "bfloat16", moments)
    cfg = tconfigs.get_smoke_config(arch)
    st = ttrainer.init_train_state(
        cfg, tadamw.AdamWConfig(moment_dtype=moments), 0, device="cpu")
    assert state_bytes(st) == jbytes(js)
    for bw in (2e9, 1e5, 1e3):
        assert estimate_grace_period(st, storage_bw_bytes_per_s=bw) == \
            jgrace(js, storage_bw_bytes_per_s=bw)
    assert estimate_grace_period({}) == 0


@pytest.mark.parametrize("arch", ["stablelm-12b", "qwen3-moe-30b-a3b"])
def test_jax_checkpoint_loads_through_the_converter(tmp_path, arch):
    """A file JAX's ``save_pytree`` wrote (bf16 parameters and moments,
    stacked layers; the moe's expert stacks) reads back in the port and
    converts to the port's state with every value in place."""
    _, _, js = jax_state(arch, "bfloat16", "bfloat16", seed=3)
    path = str(tmp_path / "jax.npz")
    jsave(js, path)
    tree = load_tree(path)
    assert tree["params"]["embed"].dtype == torch.bfloat16
    cfg = tconfigs.get_smoke_config(arch)
    st = convert.train_state_from_numpy(cfg, tree, "cpu")
    assert st["opt"]["step"].dtype == torch.int32
    model = st["params"]
    names = {id(p): n for n, p in model.named_parameters()}
    jnp_state = np_tree(js)
    for p, want, name in param_pairs(model, jnp_state["params"]):
        assert p.requires_grad and np.array_equal(to_np(p), want), name
        for which in ("m", "v"):
            got = st["opt"][which][names[id(p)]]
            assert got.dtype == torch.bfloat16
    for mom in ("m", "v"):
        for p, want, name in param_pairs(model, jnp_state["opt"][mom]):
            got = st["opt"][mom][names[id(p)]]
            assert np.array_equal(to_np(got), want), (mom, name)
    assert state_bytes(st) == jbytes(js)


# -- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-12b", "qwen3-moe-30b-a3b",
                                  "mixtral-8x22b", "internvl2-2b",
                                  "whisper-large-v3"])
def test_launch_train_smoke_on_cpu(capsys, arch):
    """The CLI trains each family's smoke config (the vlm's and audio's
    batches with their embeddings) for 3 steps on the CPU."""
    res = ttrain.main(["--arch", arch, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq-len", "16", "--log-every", "1",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("loss") == 3 and "done" in out
    assert len(res.losses) == len(res.step_s) == 3
    assert all(np.isfinite(res.losses))
    assert int(res.state["opt"]["step"]) == 3


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_launch_trains_the_ssm_and_hybrid_smoke_configs(capsys, arch):
    test_launch_train_smoke_on_cpu(capsys, arch)


def test_train_resumes_from_a_checkpoint(tmp_path):
    """Steps 3-4 replayed from the state saved after step 2 give the
    uninterrupted run's losses and parameters bit for bit (what phase
    train of ``chip_smoke.py`` checks at full width on the card)."""
    cfg = tconfigs.get_smoke_config("stablelm-12b")
    path = str(tmp_path / "s2.npz")
    kw = dict(steps=4, batch=2, seq_len=16, device="cpu", log=None)

    def save_after_two(i, state, metrics):
        if i == 1:
            save_pytree(state, path)

    full = ttrain.train(cfg, on_step=save_after_two, **kw)
    fresh = ttrainer.init_train_state(cfg, ttrain.opt_config(4, 1e-3), 9,
                                      device="cpu")
    replay = ttrain.train(cfg, state=load_pytree(fresh, path), start=2,
                          **kw)
    assert replay.losses == full.losses[2:]
    for (n, a), (_, b) in zip(full.state["params"].named_parameters(),
                              replay.state["params"].named_parameters()):
        assert torch.equal(a, b), n
