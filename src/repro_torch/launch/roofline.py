"""Roofline terms for one (arch × shape × mesh) on H100s (counterpart of
``repro.launch.roofline``).

Three terms, in seconds, with the constants of ``launch/h100.py``:

  compute    = FLOPs             / (chips * 989e12)
  memory     = HBM bytes         / (chips * 3.35e12)
  collective = link bytes/device / 50e9

FLOPs and HBM bytes come from the JAX package's analytic per-arch model
(:func:`analytic_costs`), with the same arithmetic. The JAX package
parses collective bytes out of the compiled HLO (its
``collective_bytes``); PyTorch compiles no SPMD program, so there is no
HLO here and that parser is not ported. :func:`plan_collectives`
counts them from the plan instead: tensor-parallel all-reduces of the
residual stream, FSDP gathers and gradient reductions, data-parallel
gradient all-reduces, the moe's all-to-alls and the decode cache's
sequence-parallel reduction, each at one device's bytes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch import models
from repro_torch import tree as _tree
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import h100
from repro_torch.models import common
from repro_torch.sharding import constraints, plans

PEAK_FLOPS = h100.PEAK_BF16_FLOPS        # bf16 / device
HBM_BW = h100.HBM_BYTES_PER_S            # bytes/s / device
LINK_BW = h100.COLLECTIVE_BYTES_PER_S    # bytes/s / device

# traffic multiplier per collective kind (ring algorithms, large-n
# limit), the JAX package's
_COLLECTIVE_FACTOR = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}


# ---------------------------------------------------------------------------
# Analytic FLOPs / HBM bytes (the JAX package's model, same arithmetic)
# ---------------------------------------------------------------------------

def _matmul_params(cfg: ModelConfig) -> Tuple[float, float]:
    """-> (active matmul params per token, total params)."""
    total = models.count_params(cfg)
    embed = cfg.vocab * cfg.d_model
    active = total - embed            # embed lookup is a gather
    if cfg.family == "moe":
        m = cfg.moe
        per_ffn = cfg.d_model * m.d_expert * (3 if cfg.gated_mlp else 2)
        inactive = cfg.n_layers * per_ffn * (m.num_experts - m.top_k)
        active -= inactive
    if cfg.tie_embeddings:
        active += cfg.vocab * cfg.d_model   # tied unembed matmul
    return float(active), float(total)


def _attn_flops_per_token(cfg: ModelConfig, kv_len: float) -> float:
    """QK^T + PV flops for one query token against kv_len keys."""
    if cfg.family == "ssm":
        s = cfg.ssm
        H = (s.expand * cfg.d_model) // s.head_dim
        # intra-chunk dual form + state update/read
        return 2.0 * H * (s.chunk * (s.d_state + s.head_dim)
                          + 2 * s.head_dim * s.d_state)
    attn_layers = cfg.n_layers
    win = cfg.window
    if cfg.family == "hybrid":
        pat = cfg.recurrent.block_pattern
        attn_layers = cfg.n_layers * pat.count("attn") / len(pat)
        win = cfg.recurrent.local_window
        R = cfg.recurrent.lru_width or cfg.d_model
        rec_layers = cfg.n_layers - attn_layers
        rec = rec_layers * 6.0 * R          # RG-LRU elementwise recurrence
    else:
        rec = 0.0
    eff = min(kv_len, win) if win > 0 else kv_len
    return 4.0 * attn_layers * eff * cfg.n_heads * cfg.head_dim + rec


def analytic_costs(cfg: ModelConfig, shape: InputShape) -> Dict[str, float]:
    """Global (all-devices) FLOPs and HBM bytes for ONE step of this shape.

    train: fwd + bwd (2x) + full-remat recompute (~1x) = 4x matmul fwd.
    decode: one token per sequence against the cache.
    Returns MODEL_FLOPS (6·N_active·D, the "useful" number) separately.
    """
    active, total = _matmul_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    p_bytes = 2.0                      # bf16 params
    if shape.kind == "train":
        tokens = float(B) * S
        mm = 2.0 * active * tokens * 4.0          # fwd+bwd+remat
        # causal attention: mean kv_len = S/2 (fwd), x4 train multiplier
        at = _attn_flops_per_token(cfg, S / 2) * tokens * 4.0
        flops = mm + at
        model_flops = 6.0 * active * tokens
        # params fwd+bwd + grads + adam m/v read+write (f32-equivalents)
        opt_bytes = 2 * total * 4.0
        hbm = (2 * total * p_bytes            # fwd + bwd param reads
               + total * 4.0                  # grad write (f32)
               + 2 * opt_bytes                # moments read + write
               + tokens * cfg.d_model * p_bytes * cfg.n_layers * 2)  # acts
    elif shape.kind == "prefill":
        tokens = float(B) * S
        flops = 2.0 * active * tokens + \
            _attn_flops_per_token(cfg, S / 2) * tokens
        model_flops = 2.0 * active * tokens
        hbm = total * p_bytes + tokens * cfg.d_model * p_bytes * \
            cfg.n_layers * 2
    else:   # decode: ONE new token, cache of seq_len
        tokens = float(B)
        kv_len = float(S)
        flops = 2.0 * active * tokens + \
            _attn_flops_per_token(cfg, kv_len) * tokens
        model_flops = 2.0 * active * tokens
        hbm = total * p_bytes + _cache_bytes(cfg, B, S)
    return {"flops": flops, "model_flops": model_flops, "hbm_bytes": hbm}


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    if cfg.family == "ssm":
        s = cfg.ssm
        H = (s.expand * cfg.d_model) // s.head_dim
        return 2.0 * cfg.n_layers * B * H * s.head_dim * s.d_state * 2
    win = cfg.window or (cfg.decode_window if S > 65536 else 0)
    eff = min(S, win) if win > 0 else S
    kv = 2.0 * cfg.n_layers * B * eff * cfg.n_kv_heads * cfg.head_dim * 2
    if cfg.family == "hybrid":
        pat = cfg.recurrent.block_pattern
        kv *= pat.count("attn") / len(pat)
        R = cfg.recurrent.lru_width or cfg.d_model
        kv += 2.0 * cfg.n_layers * pat.count("rec") / len(pat) * B * R * 2
    return kv


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    counted_flops: float          # one device's, counted on meta
    analytic_flops: float
    dominant: str
    useful_ratio: float           # MODEL_FLOPS / analytic FLOPs


def roofline(cfg: ModelConfig, shape: InputShape, n_chips: int,
             coll_bytes_per_device: float,
             counted_flops: float = 0.0) -> Roofline:
    a = analytic_costs(cfg, shape)
    compute_s = a["flops"] / (n_chips * PEAK_FLOPS)
    memory_s = a["hbm_bytes"] / (n_chips * HBM_BW)
    collective_s = coll_bytes_per_device / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=a["model_flops"], counted_flops=counted_flops,
        analytic_flops=a["flops"], dominant=dominant,
        useful_ratio=a["model_flops"] / max(a["flops"], 1.0),
    )


# ---------------------------------------------------------------------------
# Collective bytes counted from the plan
# ---------------------------------------------------------------------------

def row_tokens(cfg: ModelConfig, shape: InputShape) -> int:
    """Positions a batch row carries through the decoder stack (the
    vlm's visual prefix included, as ``input_specs`` builds it); 1 in
    decode."""
    if shape.kind == "decode":
        return 1
    if cfg.family == "vlm":
        nv = cfg.vlm.n_visual_tokens
        return nv + max(shape.seq_len - nv, 8)
    if cfg.family == "audio":
        return max(shape.seq_len - cfg.encoder.n_frontend_tokens, 8)
    return shape.seq_len


def _blocks(cfg: ModelConfig, shape: InputShape) -> List[tuple]:
    """Each kind of block that ends in a row-parallel product:
    (blocks per step, positions a row, the hidden dims the product
    contracts, kind). Attention contracts (heads, head_dim), an MLP
    d_ff, the ssm's mixer d_inner, the RG-LRU its width; "moe" is the
    routed expert layer."""
    T = row_tokens(cfg, shape)
    L = cfg.n_layers
    attn, mlp = (cfg.n_heads, cfg.head_dim), (cfg.d_ff,)
    if cfg.family in ("dense", "vlm"):
        return [(L, T, attn, "attn"), (L, T, mlp, "mlp")]
    if cfg.family == "moe":
        return [(L, T, attn, "attn"), (L, T, (cfg.moe.d_expert,), "moe")]
    if cfg.family == "ssm":
        return [(L, T, (cfg.ssm.expand * cfg.d_model,), "mixer")]
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        _, _, n_rec, n_attn = hybrid.layer_layout(cfg)
        R = cfg.recurrent.lru_width or cfg.d_model
        return [(n_rec, T, (R,), "mixer"), (n_rec, T, mlp, "mlp"),
                (n_attn, T, attn, "attn"), (n_attn, T, mlp, "mlp")]
    if cfg.family == "audio":
        Le, Fr = cfg.encoder.n_layers, cfg.encoder.n_frontend_tokens
        enc = [] if shape.kind == "decode" else \
            [(Le, Fr, attn, "attn"), (Le, Fr, mlp, "mlp")]
        return enc + [(L, T, attn, "attn"), (L, T, attn, "attn"),
                      (L, T, mlp, "mlp")]
    raise KeyError(f"unknown model family {cfg.family!r}")


def _attn_cache_layers(cfg: ModelConfig) -> int:
    """Layers that read a KV cache in decode."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        return hybrid.layer_layout(cfg)[3]
    return cfg.n_layers


def _remat_share(cfg: ModelConfig, path: tuple, stacked: bool) -> float:
    """The share of a parameter leaf's slices whose layer is recomputed
    under remat "full": all of a stacked leaf's, but the hybrid's
    remainder layers (past its last whole pattern group) are not
    (``hybrid.hidden``), nor any unstacked leaf."""
    if not stacked:
        return 0.0
    if cfg.family != "hybrid":
        return 1.0
    from repro_torch.models import hybrid
    g, _, n_rec, n_attn = hybrid.layer_layout(cfg)
    kind = path[0]
    n = n_rec if kind == "rec" else n_attn
    return g * cfg.recurrent.block_pattern.count(kind) / max(n, 1)


def fsdp_gathered(cfg: ModelConfig, shape: InputShape, plan, mesh
                  ) -> Dict[tuple, int]:
    """path -> one device's bytes of each FSDP leaf once gathered: the
    leaves split over a gather axis (``plans.gather_axes``), at their
    shard's bytes times those axes' sizes (a model-axis split stays).
    Decode leaves out the leaves it does not read (whisper's encoder,
    the vlm's projector)."""
    p_sh = dict(_tree.flatten(plans.param_sharding(cfg, plan, mesh)))
    p_abs = dict(_tree.flatten(models.abstract_params(cfg)))
    axes = plans.gather_axes(plan, mesh)
    out = {}
    for path, sh in p_sh.items():
        if shape.kind == "decode" and path[0] in ("enc", "projector"):
            continue
        n = plans._prod(mesh, [a for a in sh.axes if a in axes])
        if n > 1:
            out[path] = math.prod(sh.shard_shape) \
                * p_abs[path].element_size() * n
    return out


def fsdp_unit_bytes(cfg: ModelConfig, shape: InputShape, plan, mesh
                    ) -> int:
    """The largest unit of weights that FSDP holds gathered at once, in
    one device's bytes (:func:`fsdp_gathered`): one layer of a stack
    (its stacked leaves' gathered bytes over the stack's depth, per
    stack) or one unstacked leaf (a tied embedding); 0 without FSDP
    leaves."""
    p_logical = dict(_tree.flatten(models.param_logical_specs(cfg)))
    p_abs = dict(_tree.flatten(models.abstract_params(cfg)))
    units: Dict[tuple, int] = {}
    for path, full in fsdp_gathered(cfg, shape, plan, mesh).items():
        if p_logical[path] and p_logical[path][0] == "layers":
            key = path[:-1]
            units[key] = units.get(key, 0) + full // p_abs[path].shape[0]
        else:
            units[path] = full
    return max(units.values(), default=0)


def plan_collectives(cfg: ModelConfig, shape: InputShape, plan, mesh
                     ) -> Dict[str, float]:
    """One device's collective bytes for one step of ``shape`` under
    ``plan`` on ``mesh``, by kind and ``"total"``, each collective's
    bytes times its ring factor (``_COLLECTIVE_FACTOR``).

    Passes: a train step runs each layer forward, backward and (under
    remat "full") again in the backward's recompute; prefill forward
    once; decode forward once at one position a row. Activations are in
    ``cfg.dtype``; one device's rows are its shard of the batch."""
    out = {k: 0.0 for k in _COLLECTIVE_FACTOR}
    train = shape.kind == "train"
    full_remat = train and plan.remat == "full"
    passes = 1 + int(train) + int(full_remat)
    micro = plan.microbatches if train else 1
    act = common.torch_dtype(cfg.dtype).itemsize
    B = shape.global_batch
    rows = plans.device_rows(B, plan, mesh)
    D = cfg.d_model
    tp = plans.tp_size(plan, mesh) > 1
    p_sh = dict(_tree.flatten(plans.param_sharding(cfg, plan, mesh)))
    p_abs = dict(_tree.flatten(models.abstract_params(cfg)))
    p_logical = dict(_tree.flatten(models.param_logical_specs(cfg)))

    def resolve(shp, *spec):
        return constraints.constrain(shp, *spec, mesh=mesh,
                                     strategy=plan.strategy) \
            or (None,) * len(shp)

    # Tensor parallelism (Megatron-LM's ColumnParallelLinear ->
    # RowParallelLinear): a block whose hidden dims are split over
    # "model" ends in a row-parallel product of partial sums, one
    # all-reduce of the residual stream (rows x T x D) a pass. Under
    # sequence parallelism (tp_sp, the residual stream's sequence dim
    # over "model") it is a reduce-scatter after the block and an
    # all-gather before the next, of equal volume (Megatron-SP).
    # Expert parallelism (the moe's experts over "model"): two
    # all-to-alls a pass, dispatch and combine, of the capacity slots'
    # activations (rows x E x C x D).
    for count, T, hidden, kind in _blocks(cfg, shape) if tp else ():
        x_bytes = rows * T * D * act
        if kind == "moe":
            w_up = p_sh[("layers", "w_up")].spec
            if "model" in plans.entry_axes(w_up[1]):
                from repro_torch.models import moe
                E = cfg.moe.num_experts
                slots = rows * E * moe.capacity(cfg, T) * D * act
                out["all-to-all"] += 2 * count * passes * slots
                continue
        h_spec = resolve((rows, T) + hidden, constraints.BATCH, None,
                         "model", *[None] * (len(hidden) - 1))
        if "model" not in plans.entry_axes(h_spec[2]):
            continue
        o_spec = resolve((rows, T, D), constraints.BATCH, constraints.SEQ,
                         None)
        if "model" in plans.entry_axes(o_spec[1]):
            out["reduce-scatter"] += count * passes * x_bytes
            out["all-gather"] += count * passes * x_bytes
        else:
            out["all-reduce"] += 2.0 * count * passes * x_bytes

    # Flash-decode over a sequence-split cache (cache_seq over "model"):
    # each device attends its slice of the keys, and one all-reduce a
    # layer combines the partial outputs (rows x H x hd).
    if shape.kind == "decode" and _attn_cache_layers(cfg) and tp:
        c_abs = models.init_decode_cache(cfg, B, shape.seq_len,
                                         abstract=True)
        k_spec = plans.cache_sharding(cfg, plan, mesh, c_abs)["k"].spec
        if "model" in plans.entry_axes(k_spec[2]):
            out["all-reduce"] += 2.0 * _attn_cache_layers(cfg) * rows \
                * cfg.n_heads * cfg.head_dim * act

    # Weights: a leaf split over a batch or data axis is FSDP (ZeRO-3):
    # all-gathered over those axes at each use (forward, the backward,
    # and the recompute of a rematerialised layer; once a microbatch)
    # and its gradient reduce-scattered back (once a microbatch). A
    # gradient not split over every batch axis is all-reduced over the
    # rest (data parallelism), once a step after the microbatches'
    # float32 accumulation.
    for path, full in fsdp_gathered(cfg, shape, plan, mesh).items():
        stacked = bool(p_logical[path]) and p_logical[path][0] == "layers"
        uses = 1.0
        if train:
            uses = 2.0 + int(full_remat) * _remat_share(cfg, path, stacked)
        out["all-gather"] += full * uses * micro
        if train:
            out["reduce-scatter"] += full * micro
    for path, sh in p_sh.items() if train else ():
        rest = [a for a in plan.batch_axes if a not in sh.axes]
        if plans._prod(mesh, rest) > 1:
            g_bytes = math.prod(sh.shard_shape) * (
                p_abs[path].element_size() if micro == 1 else 4)
            out["all-reduce"] += 2.0 * g_bytes

    out["total"] = sum(out.values())
    return out
