"""The port's dry-run against the JAX package's: abstract trees, plans and
specs, activation layouts, the analytic roofline, the collective count,
the kernel wrappers' meta route and ``merge_results``.

Everything runs on shapes alone (meta tensors, JAX ShapeDtypeStructs,
mesh descriptions): full-size configs cost no memory. The JAX dry-run
module itself is not imported: it sets ``XLA_FLAGS`` at import.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro import configs as jconfigs
from repro import models as jmodels
from repro import trainer as jtrainer
from repro.configs import cluster as jcluster
from repro.core import metrics as jmetrics
from repro.core import simulator as jsimulator
from repro.launch import roofline as jroofline
from repro.optim import AdamWConfig as JAdamWConfig
from repro.sharding import constraints as jconstraints
from repro.sharding import plans as jplans
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import trainer as ttrainer
from repro_torch import tree as ttree
from repro_torch.configs import cluster as tcluster
from repro_torch.core import metrics as tmetrics
from repro_torch.core import simulator as tsimulator
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as tssd
from repro_torch.launch import dryrun, h100, mesh as tmesh
from repro_torch.launch import roofline as troofline
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import constraints as tconstraints
from repro_torch.sharding import plans as tplans

ARCHS = tconfigs.list_archs()
SHAPES = list(tconfigs.INPUT_SHAPES)
CASES = [(a, s) for a in ARCHS for s in SHAPES]
SUPPORTED = [(a, s) for a, s in CASES if tconfigs.shape_is_supported(a, s)]


class FakeMesh:
    """A JAX-side mesh description (``tests/test_sharding_dryrun.py``'s):
    the plans read only ``axis_names`` and ``shape``."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": (FakeMesh({"data": 16, "model": 16}),
                     tmesh.make_production_mesh()),
          "multi": (FakeMesh({"pod": 2, "data": 16, "model": 16}),
                    tmesh.make_production_mesh(multi_pod=True))}


def jflat(tree):
    """path -> leaf of a JAX tree; a tuple (a spec) is a leaf."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {tuple(k.key for k in path): leaf for path, leaf in leaves}


def tflat(tree):
    return dict(ttree.flatten(tree))


def described(flat):
    """path -> (shape, dtype name) of a tree's leaves, JAX or port."""
    out = {}
    for path, leaf in flat.items():
        dt = str(leaf.dtype).replace("torch.", "")
        out[path] = (tuple(leaf.shape), dt)
    return out


def jvariant(arch, shape_name):
    """The JAX dry-run's ``variant_config`` (its module is not imported:
    it sets XLA_FLAGS)."""
    cfg = jconfigs.get_config(arch)
    if shape_name == "long_500k" and cfg.window == 0 and cfg.decode_window:
        cfg = cfg.replace(window=cfg.decode_window)
    return cfg


# ---------------------------------------------------------------------------
# Configs, meshes, abstract trees
# ---------------------------------------------------------------------------

def test_shape_skips_match_jax():
    assert tconfigs.SHAPE_SKIPS == jconfigs.SHAPE_SKIPS
    for a, s in CASES:
        assert tconfigs.shape_is_supported(a, s) == \
            jconfigs.shape_is_supported(a, s)


def test_meshes_describe_the_jax_production_meshes():
    single, multi = (MESHES[k][1] for k in ("single", "multi"))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    local = tmesh.make_local_mesh(device="cpu")
    assert local.axis_names == ("data", "model") and local.sizes == (1, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_specs_match_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    got = tflat(tmodels.abstract_params(tcfg))
    assert all(t.device.type == "meta" for t in got.values())
    assert described(got) == described(jflat(jmodels.abstract_params(jcfg)))
    assert tflat(tmodels.param_logical_specs(tcfg)) == \
        jflat(jmodels.param_logical_specs(jcfg))
    model = tmodels.abstract_model(tcfg, requires_grad=True)
    assert sum(p.numel() for p in model.parameters()) == \
        jmodels.count_params(jcfg)
    assert all(p.is_meta and p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_train_state_matches_jax(arch, moments):
    got = ttrainer.abstract_train_state(
        tconfigs.get_config(arch), AdamWConfig(moment_dtype=moments))
    want = jtrainer.abstract_train_state(
        jconfigs.get_config(arch), JAdamWConfig(moment_dtype=moments))
    assert described(tflat(got)) == described(jflat(want))


@pytest.mark.parametrize("arch,shape_name",
                         [(a, s) for a, s in SUPPORTED
                          if s in ("decode_32k", "long_500k")])
def test_abstract_cache_and_specs_match_jax(arch, shape_name):
    tcfg = dryrun.variant_config(arch, shape_name)
    jcfg = jvariant(arch, shape_name)
    assert tcfg.window == jcfg.window
    shape = tconfigs.INPUT_SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    got = tflat(tmodels.init_decode_cache(tcfg, B, S, abstract=True))
    want = jflat(jmodels.init_decode_cache(jcfg, B, S, abstract=True))
    assert described(got) == described(want)
    assert tflat(tmodels.cache_logical_specs(tcfg)) == \
        jflat(jmodels.cache_logical_specs(jcfg))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, kind):
    got = tmodels.input_specs(tconfigs.get_config(arch), 32, 4096, kind)
    want = jmodels.input_specs(jconfigs.get_config(arch), 32, 4096, kind)
    assert described(tflat(got)) == described(jflat(want))


# ---------------------------------------------------------------------------
# Plans, specs, shard shapes
# ---------------------------------------------------------------------------

def jbatch_spec(shape, plan, mesh):
    """``repro.sharding.plans.batch_sharding``'s leading-dim rule."""
    ba = tuple(a for a in plan.batch_axes if a in mesh.axis_names)
    if ba and shape and shape[0] % jplans._prod(mesh, ba) == 0:
        return (ba if len(ba) > 1 else ba[0],)
    return ()


def padded(spec, ndim):
    """A JAX ``PartitionSpec`` as the port holds it: one entry per dim."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def assert_shardings(got, jspecs, jshapes, plan, jmesh, tmesh_):
    """Every leaf's spec equals JAX's ``spec_from_logical`` and its shard
    shape divides the leaf by the spec's axes."""
    got = tflat(got)
    assert set(got) == set(jshapes)
    for path, sh in got.items():
        shape = tuple(jshapes[path].shape)
        want = jplans.spec_from_logical(jspecs[path], shape, plan, jmesh)
        assert sh.spec == padded(want, len(shape)), path
        for d, s, e in zip(shape, sh.shard_shape, sh.spec):
            assert s * tplans._prod(tmesh_, tplans.entry_axes(e)) == d


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch,shape_name", CASES)
def test_plans_and_specs_match_jax(arch, shape_name, mesh_name):
    jmesh, tm = MESHES[mesh_name]
    jcfg, tcfg = jvariant(arch, shape_name), \
        dryrun.variant_config(arch, shape_name)
    shape = tconfigs.INPUT_SHAPES[shape_name]
    jshape = jconfigs.INPUT_SHAPES[shape_name]
    jplan = jplans.arch_plan(jcfg, jshape, jmesh)
    tplan = tplans.arch_plan(tcfg, shape, tm)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)

    jspecs = jflat(jmodels.param_logical_specs(jcfg))
    jshapes = jflat(jmodels.abstract_params(jcfg))
    ps = tplans.param_sharding(tcfg, tplan, tm)
    assert_shardings(ps, jspecs, jshapes, jplan, jmesh, tm)
    state = tplans.train_state_sharding(tcfg, tplan, tm)
    assert tflat(state["opt"]["m"]) == tflat(ps) == tflat(state["opt"]["v"])
    assert state["opt"]["step"].spec == ()

    B, S = shape.global_batch, shape.seq_len
    batch = tmodels.input_specs(tcfg, B, S, shape.kind)
    for name, sh in tplans.batch_sharding(batch, tplan, tm).items():
        want = jbatch_spec(tuple(batch[name].shape), jplan, jmesh)
        assert sh.spec == padded(want, batch[name].dim()), name

    if shape.kind == "decode" and tconfigs.shape_is_supported(arch,
                                                              shape_name):
        jcache = jflat(jmodels.init_decode_cache(jcfg, B, S, abstract=True))
        tcache = tmodels.init_decode_cache(tcfg, B, S, abstract=True)
        assert_shardings(tplans.cache_sharding(tcfg, tplan, tm, tcache),
                         jflat(jmodels.cache_logical_specs(jcfg)), jcache,
                         jplan, jmesh, tm)


# the spec forms the JAX models pin (models/dense.py, models/hybrid.py)
B_, SEQ_, N_ = jconstraints.BATCH, jconstraints.SEQ, None
CONSTRAIN_CASES = [
    ((32, 4096, 32, 128), (B_, N_, "model", N_)),
    ((32, 4096, 8, 128), (B_, N_, "model", N_)),
    ((32, 4096, 20, 64), (B_, N_, "model", N_)),
    ((32, 4096, 5120), (B_, SEQ_, N_)),
    ((32, 4100, 5120), (B_, SEQ_, N_)),
    ((32, 4096, 13824), (B_, N_, "model")),
    ((32, 4096, 4096), (B_, N_, N_)),
    ((1, 4096, 5120), (B_, SEQ_, N_)),
    ((2, 1, 5120), (B_, N_, "model")),
    ((256, 4096, 5120), (B_, SEQ_, N_)),
    ((512, 4096, 5120), (B_, N_, "model")),
    ((8, 2048), ("data", "pod")),
    ((8, 2048), (N_, N_)),
]


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("strategy", ["tp", "tp_sp", "fsdp"])
def test_constrain_resolution_matches_jax(strategy, mesh_name, monkeypatch):
    jmesh, tm = MESHES[mesh_name]
    pinned = []
    monkeypatch.setattr(jconstraints, "_ambient_mesh", lambda: jmesh)
    monkeypatch.setattr(jconstraints, "_STRATEGY", strategy)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: pinned.append(tuple(spec)) or x)
    for shape, spec in CONSTRAIN_CASES:
        pinned.clear()
        x = jax.ShapeDtypeStruct(shape, jax.numpy.bfloat16)
        assert jconstraints.constrain(x, *spec) is x
        want = pinned[0] if pinned else None
        assert tconstraints.constrain(shape, *spec, mesh=tm,
                                      strategy=strategy) == want, \
            (shape, spec)
    assert tconstraints.constrain((4, 4), B_, N_, mesh=None,
                                  strategy=strategy) is None


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape_name", CASES)
def test_analytic_costs_bit_equal_and_roofline_terms(arch, shape_name):
    tcfg, jcfg = dryrun.variant_config(arch, shape_name), \
        jvariant(arch, shape_name)
    shape = tconfigs.INPUT_SHAPES[shape_name]
    jshape = jconfigs.INPUT_SHAPES[shape_name]
    assert troofline.analytic_costs(tcfg, shape) == \
        jroofline.analytic_costs(jcfg, jshape)
    assert troofline._matmul_params(tcfg) == jroofline._matmul_params(jcfg)
    n, coll = 256, 3.5e9
    t = troofline.roofline(tcfg, shape, n, coll, 1e12)
    j = jroofline.roofline(jcfg, jshape, n, coll, 1e12)
    # FLOPs and bytes recovered from the terms: JAX's v5e constants
    # there, the H100's here
    assert t.compute_s * n * h100.PEAK_BF16_FLOPS == \
        pytest.approx(j.compute_s * n * jroofline.PEAK_FLOPS, rel=1e-14)
    assert t.memory_s * n * h100.HBM_BYTES_PER_S == \
        pytest.approx(j.memory_s * n * jroofline.HBM_BW, rel=1e-14)
    assert t.collective_s * h100.COLLECTIVE_BYTES_PER_S == \
        pytest.approx(j.collective_s * jroofline.ICI_BW, rel=1e-14)
    assert (t.model_flops, t.analytic_flops, t.useful_ratio) == \
        (j.model_flops, j.analytic_flops, j.useful_ratio)
    terms = {"compute": t.compute_s, "memory": t.memory_s,
             "collective": t.collective_s}
    assert t.dominant == max(terms, key=terms.get)


def test_h100_constants_feed_chip_smoke():
    assert chip_smoke.PEAK_BYTES_PER_S == h100.HBM_BYTES_PER_S == 3.35e12
    assert chip_smoke.PEAK_BF16_PER_S == chip_smoke.PEAK_BF16_FLOPS \
        == h100.PEAK_BF16_FLOPS == 989e12
    assert chip_smoke.PEAK_F32_PER_S == 67e12
    assert chip_smoke.PEAK_TF32_PER_S == 495e12
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        assert chip_smoke.active_matmul_params(cfg) == \
            troofline._matmul_params(cfg)[0]


# ---------------------------------------------------------------------------
# The collective count: hand-worked cases
# ---------------------------------------------------------------------------

def tiny(**kw):
    """A 2-layer dense config small enough to count by hand (the plans
    key on the name, so it is nobody's)."""
    base = dict(name="tiny", family="dense", source="test", n_layers=2,
                d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256)
    base.update(kw)
    return tconfigs.ModelConfig(**base)


MESH_2x4 = tmesh.Mesh(("data", "model"), (2, 4))


def collectives(cfg, shape, mesh):
    plan = tplans.arch_plan(cfg, shape, mesh)
    return tplans, plan, troofline.plan_collectives(cfg, shape, plan, mesh)


def test_plan_collectives_tp_train_by_hand():
    # tp + dp: batch 4 over data (2 rows a device), heads and mlp over
    # model (4), remat "full": 3 passes (forward, backward, recompute)
    cfg, shape = tiny(), tconfigs.InputShape("t", 8, 4, "train")
    _, plan, c = collectives(cfg, shape, MESH_2x4)
    assert (plan.strategy, plan.batch_axes) == ("tp", ("data",))
    x = 2 * 8 * 64 * 2                       # rows x S x D x bf16
    tp = 2.0 * (2 + 2) * 3 * x               # 2 layers x (attn, mlp)
    # data-parallel gradient all-reduce of every leaf's model shard:
    # embed, out_head (V/4 x D); final_norm; per stack: 2 norms, wq, wk,
    # wv, wo (H/4), w_up, w_gate, w_down (F/4)
    leaves = (2 * 64 * 64 * 2 + 64 * 2 + 2 * (2 * 64 * 2)
              + 4 * (2 * 64 * 1 * 16 * 2) + 3 * (2 * 64 * 32 * 2))
    # the vocabulary over model: the embedding's forward all-reduce and
    # the unembedding's input gradient (rows x S x D, bf16), the
    # cross-entropy's max and sum (rows x S, f32)
    vocab = 2.0 * 2 * x + 2.0 * 2 * (2 * 8 * 4)
    assert c["all-reduce"] == tp + 2.0 * leaves + vocab
    assert c["all-gather"] == c["reduce-scatter"] == c["all-to-all"] == 0
    assert c["total"] == c["all-reduce"]


def test_plan_collectives_fsdp_train_by_hand():
    # ZeRO-3: the name takes stablelm's strategy; batch 8 spans both axes
    cfg = tiny(name="stablelm-12b")
    shape = tconfigs.InputShape("t", 8, 8, "train")
    _, plan, c = collectives(cfg, shape, MESH_2x4)
    assert (plan.strategy, plan.batch_axes) == ("fsdp", ("data", "model"))
    # gathered bytes per leaf: embed and out_head 256 x 64, final_norm
    # 64 (over data only: its model replicas all-reduce their grads),
    # per stack norms 2 x 64 (data only), wq/wk/wv/wo 2 x 64 x 64,
    # w_up/w_gate/w_down 2 x 64 x 128; bf16
    top = 2 * (256 * 64 * 2)
    norm_top = 64 * 2
    norms = 2 * (2 * 64 * 2)
    attn = 4 * (2 * 64 * 64 * 2)
    mlp = 3 * (2 * 64 * 128 * 2)
    # all-gather at each use: 2 for the unstacked leaves (forward,
    # backward), 3 for the rematerialised layers' (and the recompute)
    assert c["all-gather"] == 2 * (top + norm_top) + 3 * (norms + attn + mlp)
    assert c["reduce-scatter"] == top + norm_top + norms + attn + mlp
    # the norms' data shards all-reduced over model: 64 / 2 values each
    assert c["all-reduce"] == 2.0 * (32 * 2 + 2 * (2 * 32 * 2))
    assert c["total"] == sum(c[k] for k in ("all-reduce", "all-gather",
                                            "reduce-scatter"))


def test_fsdp_gathered_layer_enters_temp_by_hand(monkeypatch):
    # ZeRO-3 train (stablelm's strategy): a layer's leaves are gathered
    # whole: 2 norms (64), wq/wk/wv/wo (64 x 64), w_up/w_gate/w_down
    # (64 x 128), bf16, more than the embedding's 256 x 64
    cfg = tiny(name="stablelm-12b")
    train = tconfigs.InputShape("t", 8, 8, "train")
    plan = tplans.arch_plan(cfg, train, MESH_2x4)
    layer = 2 * 64 * 2 + 4 * 64 * 64 * 2 + 3 * 64 * 128 * 2
    assert troofline.fsdp_unit_bytes(cfg, train, plan, MESH_2x4) == layer
    m = dryrun.dry_run(cfg, train, MESH_2x4)["memory"]
    # the weights and their gradient before the reduce-scatter
    assert m["fsdp_gather_gb"] == pytest.approx(2 * layer / 1e9)
    assert m["temp_gb"] >= m["fsdp_gather_gb"]
    # decode at batch 1: "embed" over data only, the model split stays
    decode = tconfigs.InputShape("d", 8, 1, "decode")
    plan = tplans.arch_plan(cfg, decode, MESH_2x4)
    layer = 2 * 64 * 2 + 4 * (64 * 64 * 2 // 4) + 3 * (64 * 128 * 2 // 4)
    assert troofline.fsdp_unit_bytes(cfg, decode, plan, MESH_2x4) == layer
    got = dryrun.dry_run(cfg, decode, MESH_2x4)["memory"]
    monkeypatch.setattr(troofline, "fsdp_unit_bytes", lambda *a: 0)
    without = dryrun.dry_run(cfg, decode, MESH_2x4)["memory"]
    assert got["fsdp_gather_gb"] == pytest.approx(layer / 1e9)
    assert without["fsdp_gather_gb"] == 0
    assert got["temp_gb"] - without["temp_gb"] == pytest.approx(layer / 1e9)
    # no FSDP leaf under the tp plan's prefill
    prefill = tconfigs.InputShape("p", 8, 8, "prefill")
    plan = tplans.arch_plan(cfg, prefill, MESH_2x4)
    assert troofline.fsdp_unit_bytes(cfg, prefill, plan, MESH_2x4) == 0


def test_plan_collectives_tp_sp_and_decode_by_hand():
    # Megatron-SP under nemotron's plan: 16 microbatches, FSDP of the
    # "embed" dims over data, batch 4 over data (2 rows a device)
    cfg = tiny(name="nemotron-4-340b")
    shape = tconfigs.InputShape("t", 8, 4, "train")
    _, plan, c = collectives(cfg, shape, MESH_2x4)
    assert (plan.strategy, plan.microbatches) == ("tp_sp", 16)
    # each block's all-reduce is an all-gather and a reduce-scatter of
    # the residual stream: 4 blocks x 3 passes
    sp = 4 * 3 * (2 * 8 * 64 * 2)
    # every leaf holds "embed" over data: gathered over data (its model
    # shard stays), per microbatch; embed and out_head (V/4 x D),
    # final_norm (D), the stacks' norms, attention and MLP leaves
    top = 2 * (64 * 64 * 2) + 64 * 2
    stacked = 2 * (2 * 64 * 2) + 4 * (2 * 64 * 16 * 2) \
        + 3 * (2 * 64 * 32 * 2)
    # the vocab-parallel embedding's forward and the unembedding's
    # backward: a reduce-scatter and an all-gather each under SP
    vocab = 2 * (2 * 8 * 64 * 2)
    assert c["all-gather"] == sp + vocab + 16 * (2 * top + 3 * stacked)
    assert c["reduce-scatter"] == sp + vocab + 16 * (top + stacked)
    # the cross-entropy's max and sum over the split vocab
    assert c["all-reduce"] == 2.0 * 2 * (2 * 8 * 4)
    # decode: batch 4 over data (2 rows), 1 position; the cache's
    # sequence over model: one more all-reduce a layer of (rows, H, hd)
    cfg = tiny()
    shape = tconfigs.InputShape("d", 8, 4, "decode")
    _, plan, c = collectives(cfg, shape, MESH_2x4)
    assert plan.batch_axes == ("data",)
    tp = 2.0 * 4 * 1 * (2 * 1 * 64 * 2)
    cache = 2.0 * 2 * 2 * 4 * 16 * 2
    embed = 2.0 * (2 * 1 * 64 * 2)
    assert c["all-reduce"] == tp + cache + embed
    assert c["total"] == c["all-reduce"]


def test_plan_collectives_moe_all_to_all_by_hand():
    # experts over model (4 of 4): dispatch and combine a layer
    cfg = tiny(family="moe", moe=tconfigs.MoEConfig(num_experts=4,
                                                    top_k=2, d_expert=32))
    shape = tconfigs.InputShape("p", 8, 2, "prefill")
    _, plan, c = collectives(cfg, shape, MESH_2x4)
    from repro_torch.models import moe
    C = moe.capacity(cfg, 8)
    assert C == 8                          # ceil(8*2/4*1.25) = 5 -> 8
    assert c["all-to-all"] == 2 * 2 * 1 * 4 * C * 64 * 2
    # the attention blocks' all-reduce (1 row of 8 positions) and the
    # vocab-parallel embedding's
    assert c["all-reduce"] == 2.0 * (2 + 1) * (1 * 8 * 64 * 2)
    # 6 experts do not divide a model axis of 8, so they stay whole and
    # the expert layer is tensor-parallel over d_expert instead
    m8 = tmesh.Mesh(("data", "model"), (1, 8))
    cfg6 = tiny(family="moe", moe=tconfigs.MoEConfig(num_experts=6,
                                                     top_k=2, d_expert=32),
                n_heads=8, n_kv_heads=8, head_dim=8)
    _, plan, c = collectives(cfg6, tconfigs.InputShape("p", 8, 2,
                                                       "prefill"), m8)
    assert c["all-to-all"] == 0
    assert c["all-reduce"] == 2.0 * (2 * 2 + 1) * (2 * 8 * 64 * 2)


def test_plan_collectives_vocab_terms_by_hand():
    """Each collective of a split vocabulary, alone: the tp plan's
    prefill minus its blocks is the embedding's forward all-reduce; its
    train step adds the unembedding's input-gradient all-reduce (tied
    or not) and the cross-entropy's two float32 reductions. A vocab
    that does not divide the model axis sends none (the baseline here);
    ZeRO-3 sends none either (``test_plan_collectives_fsdp_train_by_hand``
    counts its whole total)."""
    def vocab_terms(cfg, shape, mesh=MESH_2x4):
        _, plan, c = collectives(cfg, shape, mesh)
        blocks = troofline.plan_collectives(
            cfg.replace(vocab=255), shape, plan, mesh)
        return {k: c[k] - blocks[k] for k in c}

    x = 2 * 8 * 64 * 2                       # 2 rows x 8 x D, bf16
    got = vocab_terms(tiny(), tconfigs.InputShape("p", 8, 4, "prefill"))
    assert got["all-reduce"] == 2.0 * x == got["total"]
    train = tconfigs.InputShape("t", 8, 4, "train")
    for cfg in (tiny(), tiny(tie_embeddings=True)):
        got = vocab_terms(cfg, train)
        # all-reduces of 255 x 64 gradients are in both counts: only the
        # vocab leaves' gradient shards differ, so compare the new terms
        ce = 2.0 * 2 * (2 * 8 * 4)
        leaves = 2.0 * (1 if cfg.tie_embeddings else 2) * 64 * 2 * (
            64 - 255)
        assert got["all-reduce"] == 2.0 * 2 * x + ce + leaves


def test_plan_collectives_match_dtensor_tensor_parallel_layer():
    """One dense layer's forward under the tp plan on (16, 16) against
    what DTensor sends for the same layer (Megatron column-parallel
    q/k/v/up/gate, row-parallel o/down) behind a vocab-parallel
    embedding through a fake process group: the same all-reduces, in
    count and bytes."""
    import torch.distributed as dist
    from torch import nn
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils._python_dispatch import TorchDispatchMode

    D, H, hd, F, rows, S, V = 256, 16, 16, 512, 2, 64, 256
    cfg = tiny(n_layers=1, d_model=D, n_heads=H, n_kv_heads=H, d_ff=F,
               vocab=V)
    shape = tconfigs.InputShape("p", S, rows * 16, "prefill")
    mesh = tmesh.make_production_mesh()
    plan = tplans.arch_plan(cfg, shape, mesh)
    assert plan.strategy == "tp" and plan.batch_axes == ("data",)
    want = troofline.plan_collectives(cfg, shape, plan, mesh)

    class Layer(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, D)
            for n, (i, o) in dict(wq=(D, H * hd), wk=(D, H * hd),
                                  wv=(D, H * hd), wo=(H * hd, D),
                                  up=(D, F), gate=(D, F),
                                  down=(F, D)).items():
                setattr(self, n, nn.Linear(i, o, bias=False))

        def forward(self, tokens):
            x = self.embed(tokens)
            B = x.shape[0]
            q, k, v = (w(x).reshape(B, S, -1, hd).transpose(1, 2)
                       for w in (self.wq, self.wk, self.wv))
            o = nn.functional.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True)
            x = x + self.wo(o.transpose(1, 2).reshape(B, S, -1))
            return x + self.down(nn.functional.silu(self.gate(x))
                                 * self.up(x))

    class AllReduces(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == torch.ops._c10d_functional.all_reduce.default:
                self.bytes.append(args[0].numel() * args[0].element_size())
            return func(*args, **(kwargs or {}))

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        dmesh = init_device_mesh("cpu", (16, 16),
                                 mesh_dim_names=("data", "model"))
        layer = Layer().to(torch.bfloat16)
        parallelize_module(layer, dmesh["model"], {
            "embed": RowwiseParallel(input_layouts=Replicate()),
            "wq": ColwiseParallel(), "wk": ColwiseParallel(),
            "wv": ColwiseParallel(), "wo": RowwiseParallel(),
            "up": ColwiseParallel(), "gate": ColwiseParallel(),
            "down": RowwiseParallel()})
        tokens = torch.zeros(rows, S, dtype=torch.int64)
        with CommDebugMode() as comm, AllReduces() as seen:
            layer(tokens)
    finally:
        dist.destroy_process_group()
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    assert counts == {"c10d_functional.all_reduce": 3}
    assert seen.bytes == [rows * S * D * 2] * 3
    assert want["all-reduce"] == 2.0 * sum(seen.bytes) == want["total"]


# ---------------------------------------------------------------------------
# The kernel wrappers' meta route
# ---------------------------------------------------------------------------

def _meta(*ts):
    return [t.to("meta") for t in ts]


def _flops_and_launches(fn):
    ops.META_FLOPS.update({k: 0 for k in ops.META_FLOPS})
    launches = dict(ops.LAUNCHES)
    out = fn()
    assert ops.LAUNCHES == launches
    return out, dict(ops.META_FLOPS)


@pytest.mark.parametrize("causal,window,softcap,dtype", [
    (True, 0, 0.0, torch.float32), (True, 48, 0.0, torch.bfloat16),
    (True, 0, 30.0, torch.float32), (False, 0, 0.0, torch.bfloat16)])
def test_flash_attention_meta_route(causal, window, softcap, dtype):
    g = torch.Generator().manual_seed(0)
    B, Sq, Skv, H, KV, hd = 2, 128, 256, 4, 2, 32
    q = torch.randn(B, Sq, H, hd, generator=g).to(dtype)
    k = torch.randn(B, Skv, KV, hd, generator=g).to(dtype)
    v = torch.randn(B, Skv, KV, hd, generator=g).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    plain = ops.flash_attention(q, k, v, **kw)
    out, flops = _flops_and_launches(
        lambda: ops.flash_attention(*_meta(q, k, v), **kw))
    assert out.is_meta and out.shape == plain.shape
    assert out.dtype == plain.dtype
    # the (query, key) pairs of the kernel's mask, 4·hd FLOPs each a head
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    mask = (kpos <= qpos) if causal else np.ones((Sq, Skv), bool)
    if window:
        mask &= kpos > qpos - window
    want = 4 * B * H * hd * int(mask.sum())
    assert flops["flash_attention"] == want > 0
    assert tflash.flops(B, Sq, Skv, H, hd, causal=causal,
                        window=window) == want
    qm = q.to("meta").requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(qm, *_meta(k, v), **kw)


def test_attend_routes_meta_to_the_kernel_shape():
    from repro_torch.models import attention, common
    q = torch.empty(1, 64, 4, 16, device="meta")
    k = torch.empty(1, 64, 2, 16, device="meta")
    mask = common.causal_mask(64, 64, device="meta")
    out, flops = _flops_and_launches(lambda: attention.attend(
        q, k, k, mask=mask, causal=True))
    assert out.shape == (1, 64, 4, 16) and flops["flash_attention"] > 0
    # no hint: the plain path (what training takes by route)
    out, flops = _flops_and_launches(lambda: attention.attend(
        q, k, k, mask=mask))
    assert out.shape == (1, 64, 4, 16) and flops["flash_attention"] == 0


@pytest.mark.parametrize("L", [256, 300])
def test_ssd_chunk_meta_route(L):
    g = torch.Generator().manual_seed(1)
    B, H, P, N = 2, 3, 8, 16
    xdt = torch.randn(B, L, H, P, generator=g)
    loga = -torch.rand(B, L, H, generator=g)
    Bm, Cm = (torch.randn(B, L, H, N, generator=g) for _ in range(2))
    plain = ops.ssd_chunk(xdt, loga, Bm, Cm)
    out, flops = _flops_and_launches(
        lambda: ops.ssd_chunk(*_meta(xdt, loga, Bm, Cm)))
    assert out.is_meta and out.shape == plain.shape
    assert out.dtype == plain.dtype
    # per (b, h) and query i of a 256-chunk, i + 1 keys, each N + P
    # multiply-adds
    pairs = sum(q * (q + 1) // 2 for q in (256, L - 256) if q)
    assert flops["ssd_chunk"] == tssd.flops(B, L, H, P, N) == \
        2 * (N + P) * pairs * B * H


@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_meta_route_and_backward(with_h0):
    g = torch.Generator().manual_seed(2)
    B, L, R = 2, 33, 8
    a = torch.rand(B, L, R, generator=g)
    b = torch.randn(B, L, R, generator=g)
    h0 = torch.randn(B, R, generator=g) if with_h0 else None
    plain = ops.lru_scan(a, b, h0)
    args = _meta(a, b) + ([h0.to("meta")] if with_h0 else [None])
    out, flops = _flops_and_launches(lambda: ops.lru_scan(*args))
    assert out.is_meta and out.shape == plain.shape
    assert out.dtype == plain.dtype
    assert flops["lru_scan"] == 2 * B * L * R
    # with gradients: LruScan's meta forward and reverse
    am, bm = (t.to("meta").requires_grad_(True) for t in (a, b))

    def fwd_bwd():
        h = ops.lru_scan(am, bm, None if h0 is None else h0.to("meta"))
        return torch.autograd.grad(h.sum(), (am, bm))

    (da, db), flops = _flops_and_launches(fwd_bwd)
    assert da.shape == db.shape == a.shape and da.is_meta
    # the forward and the reverse launch, 2·B·L·R each
    assert flops["lru_scan"] == 4 * B * L * R


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------

def test_importing_the_dry_run_sets_no_process_state():
    """Unlike the JAX dry-run (``XLA_FLAGS`` at import), importing the
    port's touches no environment variable or counter."""
    import os
    import subprocess
    import sys
    code = ("import os; env = dict(os.environ); "
            "import repro_torch.launch.dryrun; "
            "from repro_torch.kernels import ops; "
            "assert dict(os.environ) == env; "
            "assert not any(ops.META_FLOPS.values()); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": "src"},
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_step_counter_counts_live_bytes_and_flops():
    mem = dryrun.StepCounter()
    with mem:
        x = torch.empty(1000, device="meta")          # 4,000 B
        y = x + 1                                     # 8,000 live
        del x
        z = y.view(10, 100) @ torch.empty(100, 5, device="meta")
        del y
    assert mem.peak() == 8000
    assert mem.peak(exclude=[z]) == 8000
    assert mem.flops == 2 * 10 * 100 * 5


@pytest.mark.parametrize("arch,shape_name", [("mamba2-1.3b", "decode_32k"),
                                             ("internvl2-2b", "prefill_32k")])
def test_dry_run_in_process_at_full_width(arch, shape_name):
    """The two cases JAX's slow dry-run test lowers, on the meta device."""
    launches = dict(ops.LAUNCHES)
    res = dryrun.lower_one(arch, shape_name, tmesh.make_production_mesh())
    assert ops.LAUNCHES == launches
    for key in ("arch", "shape", "mesh", "n_chips", "kind", "microbatches",
                "opt_dtype", "strategy", "lower_s", "memory", "collectives",
                "roofline", "counted_flops_per_device",
                "counted_over_analytic"):
        assert key in res, key
    assert set(res["memory"]) >= {"argument_gb", "output_gb", "alias_gb",
                                  "temp_gb", "peak_gb",
                                  "temp_gb_upper_bound", "fsdp_gather_gb"}
    assert set(res["roofline"]) == {
        "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
        "analytic_flops", "useful_ratio"}
    assert "total" in res["collectives"]
    assert res["n_chips"] == 256 and res["mesh"] == "16x16"
    assert res["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert res["counted_flops_per_device"] > 0
    m = res["memory"]
    assert m["peak_gb"] == pytest.approx(
        m["argument_gb"] + m["output_gb"] - m["alias_gb"] + m["temp_gb"])
    # no consistent local config: mamba2's decode, internvl2's GQA with
    # 8 whole kv heads beside 16 / 16 query heads
    assert m["temp_gb_upper_bound"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_meta_step_runs_at_local_widths_by_hand(kind):
    """Tensor parallelism over a model axis of 4 (MHA: every head, d_ff
    and the vocab divide it): the dry-run's step is the one of the
    config divided by hand, at one device's rows on one device, in temp
    bytes and FLOPs, and it is exact; the FLOPs also by hand."""
    cfg = tiny()
    shape = tconfigs.InputShape("x", 8, 4, kind)
    plan = tplans.arch_plan(cfg, shape, MESH_2x4)
    loc = tiny(n_heads=1, n_kv_heads=1, head_dim=16, d_ff=32, vocab=64)
    assert dryrun.local_config(cfg, shape, plan, MESH_2x4) == (loc, True)
    got = dryrun.meta_step(cfg, shape, plan, MESH_2x4, AdamWConfig())
    one = tmesh.Mesh(("data", "model"), (1, 1))
    half = tconfigs.InputShape("x", 8, 2, kind)     # 2 rows a device
    want = dryrun.meta_step(loc, half, tplans.arch_plan(loc, half, one),
                            one, AdamWConfig())
    assert got["exact"] and want["exact"]
    assert got["temp_bytes"] == want["temp_bytes"]
    assert got["counted_flops"] == want["counted_flops"]
    res = dryrun.dry_run(cfg, shape, MESH_2x4)
    assert not res["memory"]["temp_gb_upper_bound"]
    assert dryrun.peak_mark(res["memory"]) == "="
    if kind == "prefill":
        # per layer q, k, v, o (64 -> 1 head of 16) and up, gate, down
        # (64 -> 32) on 2 x 8 tokens; the last position's unembedding
        # (64 -> 64); the flash kernel's causal pairs (36 a row)
        layer = 4 * 2 * 16 * 64 * 16 + 3 * 2 * 16 * 64 * 32 \
            + 4 * 2 * 1 * 16 * 36
        assert got["counted_flops"] == 2 * layer + 2 * 2 * 64 * 64


def test_gqa_with_whole_kv_heads_keeps_the_upper_bound():
    """4 query heads over 2 kv heads on a model axis of 4: the kv heads
    do not divide it, so one query head a device groups onto no kv
    head. The local run keeps both kv heads and 2 query heads (the
    fewest that group), d_ff and the vocab split, and stays flagged."""
    cfg = tiny(n_heads=4, n_kv_heads=2)
    shape = tconfigs.InputShape("p", 8, 4, "prefill")
    plan = tplans.arch_plan(cfg, shape, MESH_2x4)
    loc, exact = dryrun.local_config(cfg, shape, plan, MESH_2x4)
    assert not exact
    assert (loc.n_heads, loc.n_kv_heads, loc.head_dim, loc.d_ff,
            loc.vocab) == (2, 2, 16, 32, 64)
    res = dryrun.dry_run(cfg, shape, MESH_2x4)
    assert res["memory"]["temp_gb_upper_bound"]
    assert dryrun.peak_mark(res["memory"]) == "<="


def test_cli_prints_both_flags(monkeypatch, tmp_path, capsys):
    """A plan that is both FSDP (command-r-35b's weights over data) and
    model-split with GQA whole kv heads carries both flags, and the
    CLI's line states both."""
    cfg = tiny(name="command-r-35b", n_heads=4, n_kv_heads=2)
    res = dryrun.dry_run(cfg, tconfigs.InputShape("t", 8, 4, "train"),
                         MESH_2x4)
    m = res["memory"]
    assert m["temp_gb_upper_bound"] and m["fsdp_gather_gb"] > 0
    assert dryrun.peak_mark(m) == "<=~"
    monkeypatch.setattr(dryrun, "lower_one", lambda *a, **k: res)
    dryrun.main(["--arch", "command-r-35b", "--shape", "train_4k",
                 "--out", str(tmp_path)])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("OK    command-r-35b__train_4k__single")
    assert f"peak<=~{m['peak_gb']:.1f}GB" in line
    with pytest.raises(SystemExit):
        dryrun.main(["--help"])
    assert "peak<=~X (both)" in " ".join(capsys.readouterr().out.split())


def test_train_state_argument_bytes_equal_the_state():
    """On a (1, 1) mesh the dry-run's train-state argument bytes are the
    real state's ``state_bytes`` (what phase train checks on the card)."""
    from repro_torch.checkpoint import state_bytes
    cfg = tconfigs.get_smoke_config("stablelm-12b")
    shape = tconfigs.InputShape("t", 64, 4, "train")
    res = dryrun.dry_run(cfg, shape, tmesh.make_local_mesh(device="cpu"))
    state = ttrainer.init_train_state(cfg, AdamWConfig(), 0, device="cpu")
    assert res["memory"]["argument_bytes"]["state"] == state_bytes(state)
    assert res["memory"]["alias_gb"] * 1e9 == pytest.approx(
        state_bytes(state))
    assert not res["memory"]["temp_gb_upper_bound"]
    # one device: nothing to gather, reduce or exchange
    assert res["collectives"]["total"] == 0


def test_cli_writes_artifacts_and_skips(tmp_path, capsys):
    dryrun.main(["--arch", "whisper-large-v3", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("SKIP") == 2 and not list(tmp_path.glob("*.json"))
    dryrun.main(["--arch", "stablelm-12b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(tmp_path), "--no-run"])
    arts = list(tmp_path.glob("*.json"))
    assert [a.name for a in arts] == \
        ["stablelm-12b__decode_32k__single.json"]
    import json
    res = json.loads(arts[0].read_text())
    assert set(res["memory"]) == {"argument_gb", "argument_bytes"}
    assert "OK    stablelm-12b__decode_32k__single" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# merge_results
# ---------------------------------------------------------------------------

def test_merge_results_matches_jax():
    got, want = [], []
    for seed, policy in ((3, "fifo"), (4, "fitgpp"), (5, "lrtp")):
        kw = dict(policy=policy, seed=seed, max_preemptions=2)
        jcfg = jcluster.SimConfig(cluster=jcluster.ClusterSpec(n_nodes=8),
                                  workload=jcluster.WorkloadSpec(n_jobs=64),
                                  **kw)
        tcfg = tcluster.SimConfig(cluster=tcluster.ClusterSpec(n_nodes=8),
                                  workload=tcluster.WorkloadSpec(n_jobs=64),
                                  **kw)
        from repro import scenarios as jscenarios
        js = jscenarios.build("te-flood", jcfg)
        got.append(tsimulator.simulate(tcfg, js))
        want.append(jsimulator.simulate(jcfg, js))
    g, w = tmetrics.merge_results(got), jmetrics.merge_results(want)
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g[k], w[k])
    assert len(g["slowdown"]) == 3 * 64 and math.isfinite(
        float(np.nanmax(g["slowdown"])))
    assert tmetrics.pooled_tables(g) == jmetrics.pooled_tables(w) or \
        str(tmetrics.pooled_tables(g)) == str(jmetrics.pooled_tables(w))
