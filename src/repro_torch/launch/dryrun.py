"""Multi-pod dry-run on the meta device: every (arch × shape × mesh)
accounted on H100s, with nothing allocated on any device (counterpart
of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun [--arch all] [--shape all]
        [--mesh single|multi|both] [--out experiments/dryrun_torch]
        [--no-run]

The JAX dry-run lowers and compiles each case onto 512 forced host
devices and reads XLA's memory and cost analyses. PyTorch has no SPMD
compiler that lowers these models onto a 256-device mesh, so for each
case this one

* resolves the plan exactly as the JAX package does
  (``sharding/plans.py``) on a mesh description (``launch/mesh.py``);
* accounts every sharded input and output per device from its shard
  shape, exactly (``argument_gb``, ``output_gb``, and ``alias_gb`` for
  what JAX donates: the train state, the decode cache);
* runs one device's step on the meta device at the widths one device
  holds (:func:`local_config`, :func:`meta_step`):
  :class:`StepCounter` counts its matrix products by
  ``FlopCounterMode``'s formulas, the kernel wrappers' meta route adds
  the kernels' FLOPs, and the counter's peak bytes of activations and
  temporaries give ``temp_gb``;
* counts collective bytes from the plan
  (``roofline.plan_collectives``) and computes the roofline with H100
  constants (``launch/h100.py``).

Each artifact keeps the JAX one's keys; ``counted_flops_per_device``
and ``counted_over_analytic`` stand where JAX has its cost analysis,
and ``lower_s`` is the seconds of the meta run.

Where the plan uses "model" for tensor parallelism the meta run takes
the device's local widths: a head, kv-head, ``d_ff``, expert, RG-LRU
width or vocab dimension is divided by the model axis where
``constraints.constrain`` puts "model" on it (the JAX models' calls on
q, the MLP's and the RG-LRU's hidden; the same rule on the kv heads,
the experts and the vocab, which JAX leaves to its propagation from
the weights). ``d_model`` and the residual stream stay whole. Where no
consistent local config exists the run is an upper bound, and the
artifact says so (``memory.temp_gb_upper_bound``; its FLOPs then
over-count likewise):

* GQA whose kv heads stay whole while the query heads split (8 kv
  heads on a 16-wide axis beside 32–96 query heads, 4 beside qwen3's
  32): the local run keeps the kv heads and takes the fewest query
  heads that group onto them (``n_kv_heads``), more than the device's;
* the ssm's mixer (mamba2), whose ``d_inner = expand * d_model`` has no
  local form: it runs whole;
* an expert split whose local capacity would differ from the global
  one, or that leaves fewer experts than ``top_k``: the experts run
  whole;
* sequence parallelism (``tp_sp``): the residual stream's sequence
  split has no local form (attention sees the whole sequence), so it
  runs whole;
* decode, whose cache sequence is split over "model" (flash-decode):
  the local run reads the whole cache sequence.

The step's parameters are made before the count and its gradients left
out, so where the plan splits weights over a batch or data axis (FSDP,
ZeRO-3), ``temp_gb`` adds the largest layer's gathered weights and, in
training, their unsharded gradients (``memory.fsdp_gather_gb``, from
``roofline.fsdp_unit_bytes``): a model of what FSDP holds at a layer's
use, so there ``temp_gb`` is an estimate. The CLI marks the peak
``peak=`` (exact shapes), ``peak<=`` (an upper bound), ``peak~`` (an
estimate) or ``peak<=~`` (both). Importing this module sets no
process-wide state.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import models, trainer
from repro_torch import tree as _tree
from repro_torch.configs import (INPUT_SHAPES, SHAPE_SKIPS, get_config,
                                 list_archs, shape_is_supported)
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, common, moe
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.sharding import constraints, plans


class StepCounter(TorchDispatchMode):
    """Counts, op by op while the mode is on, the FLOPs of the matrix
    products by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``) in :attr:`flops`, and
    the bytes of the storages that ops allocate, from the op that makes
    each until it is freed. ``FlopCounterMode`` itself is not used: its
    module tracker keeps the activations that remat frees alive (a
    stablelm-12b step at 1 x 4,096 then peaks at 147.6 GB of
    temporaries instead of 10.1). An output that shares an input's
    storage (a view, an in-place result) or a storage already counted
    adds no bytes, so tensors made before the mode (the parameters, the
    inputs) never count. :meth:`peak` replays the allocations and frees,
    leaving out the storages of given tensors (a step's gradients and
    outputs)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self._live = {}      # id(storage) -> (serial, bytes)
        self._log = []       # (serial, +bytes) at allocation, -bytes at free
        self._serial = 0

    def _free(self, key):
        serial, n = self._live.pop(key)
        self._log.append((serial, -n))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        inputs = {id(t.untyped_storage()) for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in inputs or key in self._live:
                continue
            self._serial += 1
            n = st.nbytes()
            self._live[key] = (self._serial, n)
            self._log.append((self._serial, n))
            weakref.finalize(st, self._free, key)
        return out

    def peak(self, exclude=()) -> int:
        """Peak live bytes, leaving out the storages of the (still live)
        tensors in ``exclude``."""
        skip = {self._live[id(t.untyped_storage())][0] for t in exclude
                if isinstance(t, torch.Tensor)
                and id(t.untyped_storage()) in self._live}
        live = peak = 0
        for serial, n in self._log:
            if serial in skip:
                continue
            live += n
            peak = max(peak, live)
        return peak


def variant_config(arch: str, shape_name: str) -> ModelConfig:
    """Apply the long_500k sliding-window decode variant where needed."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.window == 0 and cfg.decode_window:
        cfg = cfg.replace(window=cfg.decode_window)
    return cfg


def prefill_outputs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """``models.prefill``'s outputs as meta tensors: the last position's
    logits (B, 1, V) and the cache (the dense families' over the whole
    sequence, the others' ``init_decode_cache``'s)."""
    dt = common.torch_dtype(cfg.dtype)
    logits = torch.empty((batch, 1, cfg.vocab), dtype=dt, device="meta")
    if cfg.family in ("dense", "moe", "vlm"):
        T = rf.row_tokens(cfg, InputShape("", seq_len, batch, "prefill"))
        cache = attention.abstract_cache(cfg.n_layers, batch, T,
                                         cfg.n_kv_heads, cfg.head_dim, dt)
    else:
        S = seq_len if cfg.family != "audio" else \
            max(seq_len - cfg.encoder.n_frontend_tokens, 8)
        cache = models.init_decode_cache(cfg, batch, S, abstract=True)
    return {"logits": logits, "cache": cache}


def _shapes(tree) -> dict:
    """path -> shape of a tree's tensor leaves; a host int (the port's
    ``next_pos``) as the JAX package's 0-d leaf."""
    return {p: tuple(t.shape) if isinstance(t, torch.Tensor) else ()
            for p, t in _tree.flatten(tree)}


def local_config(cfg: ModelConfig, shape: InputShape, plan, mesh):
    """-> (the config at one device's widths, exact): the module
    docstring's rule. ``exact`` is False where no consistent local
    config exists; the config returned then keeps those dimensions
    whole (or, for GQA, as few query heads as group onto the kv heads),
    so its step is an upper bound."""
    tp = plans.tp_size(plan, mesh)
    if tp == 1:
        return cfg, True
    rows = plans.device_rows(shape.global_batch, plan, mesh)
    T = rf.row_tokens(cfg, shape)
    B = constraints.BATCH

    def split(shp, *spec) -> bool:
        """Does ``constrain`` put "model" on the dim spec'd "model"?"""
        got = constraints.constrain(shp, *spec, mesh=mesh,
                                    strategy=plan.strategy)
        return got is not None and "model" in plans.entry_axes(
            got[spec.index("model")])

    kw = {}
    exact = plan.strategy != "tp_sp" and shape.kind != "decode"
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.family == "ssm":
        exact = exact and not split((rows, T, cfg.ssm.expand * cfg.d_model),
                                    B, None, "model")
    elif split((rows, T, H, hd), B, None, "model", None):
        kv = KV // tp if split((rows, T, KV, hd), B, None, "model",
                               None) else KV
        h = H // tp
        if h % kv:
            exact = False
            h = kv * math.ceil(h / kv)
        kw.update(n_heads=h, n_kv_heads=kv)
    if cfg.family == "moe":
        m = cfg.moe
        E = m.num_experts
        if split((E, T, cfg.d_model), "model", None, None):
            loc = dataclasses.replace(m, num_experts=E // tp,
                                      capacity_factor=m.capacity_factor / tp)
            if loc.top_k <= loc.num_experts and moe.capacity(
                    cfg.replace(moe=loc), T) == moe.capacity(cfg, T):
                kw["moe"] = loc
            else:
                exact = False
        elif split((rows, T, m.d_expert), B, None, "model"):
            kw["moe"] = dataclasses.replace(m, d_expert=m.d_expert // tp)
    elif cfg.d_ff and split((rows, T, cfg.d_ff), B, None, "model"):
        kw["d_ff"] = cfg.d_ff // tp
    if cfg.family == "hybrid":
        R = cfg.recurrent.lru_width or cfg.d_model
        if split((rows, T, R), B, None, "model"):
            kw["recurrent"] = dataclasses.replace(cfg.recurrent,
                                                  lru_width=R // tp)
    if cfg.family == "audio":
        enc = cfg.encoder
        Fr = enc.n_frontend_tokens
        if split((rows, Fr, enc.n_heads, hd), B, None, "model", None):
            # the decoder's kv-head rule: MHA, so the heads always group
            enc = dataclasses.replace(enc, n_heads=enc.n_heads // tp)
        if split((rows, Fr, enc.d_ff), B, None, "model"):
            enc = dataclasses.replace(enc, d_ff=enc.d_ff // tp)
        kw["encoder"] = enc
    if split((rows, T, cfg.vocab), B, None, "model"):
        kw["vocab"] = cfg.vocab // tp
    return cfg.replace(**kw), exact


def meta_step(cfg: ModelConfig, shape: InputShape, plan, mesh,
              ocfg: AdamWConfig) -> dict:
    """One device's step on the meta device at its local widths
    (:func:`local_config`): {"temp_bytes", "gather_bytes",
    "counted_flops", "exact", "seconds"}.

    train: one microbatch of the device's rows (global batch ÷ the
    plan's batch axes ÷ microbatches, at least one row) through
    ``loss_fn`` and its gradient; ``temp_bytes`` is the larger of that
    run's peak (gradients and the loss left out) and AdamW's update
    over the shard-shaped state (the gradients counted, in float32 when
    microbatches accumulate; the new state left out: it aliases the
    donated one). prefill / decode: ``models.prefill`` / one
    ``serve_step`` on the device's rows (the outputs left out). Under
    FSDP the step's peak also holds ``gather_bytes``: the largest
    layer's gathered weights, and in training their gradient before
    its reduce-scatter, in the parameters' type.
    ``counted_flops`` is the local run's matrix products' FLOPs plus
    the kernels' meta FLOPs, scaled to the device's rows; ``exact`` is
    :func:`local_config`'s (False: both are upper bounds)."""
    t0 = time.perf_counter()
    S = shape.seq_len
    gather = rf.fsdp_unit_bytes(cfg, shape, plan, mesh) \
        * (2 if shape.kind == "train" else 1)
    dev_rows = plans.device_rows(shape.global_batch, plan, mesh)
    rows = dev_rows if shape.kind != "train" else \
        max(1, math.ceil(dev_rows / plan.microbatches))
    opt_args = (cfg, plan, mesh, ocfg)
    cfg, exact = local_config(cfg, shape, plan, mesh)
    model = models.abstract_model(cfg, requires_grad=shape.kind == "train")
    for k in ops.META_FLOPS:
        ops.META_FLOPS[k] = 0
    mem = StepCounter()
    if shape.kind == "train":
        params = list(model.parameters())
        batch = models.input_specs(cfg, rows, S, "train")
        with mem:
            loss = models.loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(loss, params)
        temp = mem.peak(exclude=list(grads) + [loss]) + gather
        del loss, grads
        temp = max(temp, _update_peak(*opt_args))
    elif shape.kind == "prefill":
        batch = models.input_specs(cfg, rows, S, "prefill")
        with mem:
            logits, cache = models.prefill(cfg, model, batch)
        out = {"logits": logits, "cache": cache}
        want = prefill_outputs(cfg, rows, S)
        if _shapes(out) != _shapes(want):
            raise AssertionError(f"prefill's outputs {_shapes(out)} differ "
                                 f"from prefill_outputs' {_shapes(want)}")
        temp = mem.peak(exclude=[logits] + _tree.leaves(cache)) + gather
    else:
        cache = models.init_decode_cache(cfg, rows, S, device="meta")
        cache["next_pos"] = S - 1          # the last position's step
        tokens = models.input_specs(cfg, rows, S, "decode")["tokens"]
        with mem:
            logits, _ = models.serve_step(cfg, model, cache, tokens)
        temp = mem.peak(exclude=[logits]) + gather
    flops = mem.flops + sum(ops.META_FLOPS.values())
    if shape.kind == "train":
        flops *= dev_rows / rows
    return {"temp_bytes": temp, "gather_bytes": gather,
            "counted_flops": flops, "exact": exact,
            "seconds": time.perf_counter() - t0}


def _update_peak(cfg: ModelConfig, plan, mesh, ocfg: AdamWConfig) -> int:
    """Peak bytes of AdamW's update over one device's shard-shaped state
    on the meta device: the gradients (made inside the count) and the
    update's temporaries, the new state left out."""
    sh = dict(_tree.flatten(plans.param_sharding(cfg, plan, mesh)))
    p_abs = dict(_tree.flatten(models.abstract_params(cfg)))
    mdt = common.torch_dtype(ocfg.moment_dtype)

    def shard(path, dtype=None):
        return torch.empty(sh[path].shard_shape,
                           dtype=dtype or p_abs[path].dtype, device="meta")

    params = _tree.unflatten({p: shard(p) for p in p_abs})
    opt = {"m": _tree.unflatten({p: shard(p, mdt) for p in p_abs}),
           "v": _tree.unflatten({p: shard(p, mdt) for p in p_abs}),
           "step": torch.empty((), dtype=torch.int32, device="meta")}
    gdt = torch.float32 if plan.microbatches > 1 else None
    mem = StepCounter()
    with mem:
        grads = _tree.unflatten({p: shard(p, gdt) for p in p_abs})
        new_params, new_opt = adamw_update(grads, opt, params, ocfg)
    return mem.peak(exclude=_tree.leaves(new_params)
                    + _tree.leaves(new_opt))


def dry_run(cfg: ModelConfig, shape: InputShape, mesh, *, run: bool = True,
            arch: Optional[str] = None) -> dict:
    """The dry-run of ``cfg`` (already the shape's variant) at ``shape``
    on ``mesh`` -> the result dict (see the module docstring)."""
    t0 = time.perf_counter()
    plan = plans.arch_plan(cfg, shape, mesh)
    run_cfg = cfg.replace(remat=plan.remat)     # plan controls remat
    ocfg = AdamWConfig(moment_dtype=plan.opt_dtype)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        state = trainer.abstract_train_state(run_cfg, ocfg)
        batch = models.input_specs(run_cfg, B, S, "train")
        args = {"state": plans.shard_bytes(state, plans.train_state_sharding(
                    run_cfg, plan, mesh)),
                "batch": plans.shard_bytes(
                    batch, plans.batch_sharding(batch, plan, mesh))}
        # the new state (aliasing the donated one) and the loss and step
        alias = args["state"]
        output = alias + 8
    else:
        params = models.abstract_params(run_cfg)
        args = {"params": plans.shard_bytes(
            params, plans.param_sharding(run_cfg, plan, mesh))}
        if shape.kind == "prefill":
            batch = models.input_specs(run_cfg, B, S, "prefill")
            args["batch"] = plans.shard_bytes(
                batch, plans.batch_sharding(batch, plan, mesh))
            outs = prefill_outputs(run_cfg, B, S)
            output = plans.shard_bytes(
                outs["cache"], plans.cache_sharding(run_cfg, plan, mesh,
                                                    outs["cache"])) \
                + plans.shard_bytes(
                    {"logits": outs["logits"]},
                    plans.batch_sharding({"logits": outs["logits"]}, plan,
                                         mesh))
            alias = 0
        else:
            cache = models.init_decode_cache(run_cfg, B, S, abstract=True)
            tokens = models.input_specs(run_cfg, B, S, "decode")
            args["cache"] = plans.shard_bytes(
                cache, plans.cache_sharding(run_cfg, plan, mesh, cache))
            args["tokens"] = plans.shard_bytes(
                tokens, plans.batch_sharding(tokens, plan, mesh))
            logits = {"logits": torch.empty((B, 1, cfg.vocab), dtype=(
                common.torch_dtype(cfg.dtype)), device="meta")}
            # the new cache (aliasing the donated one) and the logits
            alias = args["cache"]
            output = alias + plans.shard_bytes(
                logits, plans.batch_sharding(logits, plan, mesh))
    argument = sum(args.values())
    result = {
        "arch": arch or cfg.name, "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh.sizes),
        "n_chips": mesh.size, "kind": shape.kind,
        "microbatches": plan.microbatches, "opt_dtype": plan.opt_dtype,
        "strategy": plan.strategy,
    }
    if not run:
        result["lower_s"] = round(time.perf_counter() - t0, 1)
        result["memory"] = {"argument_gb": argument / 1e9,
                            "argument_bytes": args}
        return result
    step = meta_step(run_cfg, shape, plan, mesh, ocfg)
    temp = step["temp_bytes"]
    result["lower_s"] = round(step["seconds"], 1)
    result["memory"] = {
        "argument_gb": argument / 1e9,
        "output_gb": output / 1e9,
        "alias_gb": alias / 1e9,
        "temp_gb": temp / 1e9,
        "peak_gb": (argument + output - alias + temp) / 1e9,
        "temp_gb_upper_bound": not step["exact"],
        "fsdp_gather_gb": step["gather_bytes"] / 1e9,
        "argument_bytes": args,
    }
    coll = rf.plan_collectives(run_cfg, shape, plan, mesh)
    result["collectives"] = coll
    r = rf.roofline(cfg, shape, mesh.size, coll["total"],
                    step["counted_flops"])
    result["roofline"] = {
        "compute_s": r.compute_s, "memory_s": r.memory_s,
        "collective_s": r.collective_s, "dominant": r.dominant,
        "model_flops": r.model_flops, "analytic_flops": r.analytic_flops,
        "useful_ratio": r.useful_ratio,
    }
    result["counted_flops_per_device"] = r.counted_flops
    result["counted_over_analytic"] = \
        r.counted_flops * mesh.size / r.analytic_flops
    return result


def peak_mark(memory: dict) -> str:
    """The CLI's mark before a case's peak GB: "<=" where ``temp_gb`` is
    an upper bound, "~" where it is an estimate (FSDP), "<=~" where
    both hold, "=" otherwise."""
    mark = ("<=" if memory.get("temp_gb_upper_bound") else "") \
        + ("~" if memory.get("fsdp_gather_gb") else "")
    return mark or "="


def lower_one(arch: str, shape_name: str, mesh, *, run: bool = True) -> dict:
    """-> result dict of ``arch`` at the named input shape (raises on a
    failure)."""
    return dry_run(variant_config(arch, shape_name),
                   INPUT_SHAPES[shape_name], mesh, run=run, arch=arch)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="Each OK line prints the device's peak GB as peak=X "
               "(exact shapes), peak<=X (an upper bound: no consistent "
               "local config, memory.temp_gb_upper_bound), peak~X (an "
               "estimate: FSDP's gathered layer added, "
               "memory.fsdp_gather_gb) or peak<=~X (both).")
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (see configs.list_archs)")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-run", action="store_true",
                    help="plans and argument bytes only, no meta step")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    t0 = time.perf_counter()
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        for arch in archs:
            for shape_name in shapes:
                if not shape_is_supported(arch, shape_name):
                    print(f"SKIP  {arch} × {shape_name}: "
                          f"{SHAPE_SKIPS[(arch, shape_name)]}")
                    continue
                tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                try:
                    res = lower_one(arch, shape_name, mesh,
                                    run=not args.no_run)
                    path = os.path.join(args.out, tag + ".json")
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    mem = res.get("memory", {})
                    roof = res.get("roofline", {})
                    le = peak_mark(mem)
                    print(f"OK    {tag}  run={res['lower_s']}s "
                          f"peak{le}{mem.get('peak_gb', 0):.1f}GB "
                          f"dominant={roof.get('dominant', '-')}")
                except Exception as e:                      # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"FAIL  {tag}: {e!r}")
                    traceback.print_exc()
    wall = time.perf_counter() - t0
    if torch.cuda.is_available():
        print(f"cuda max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated()}")
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        sys.exit(1)
    print(f"\nall dry-runs passed in {wall:.1f} s")


if __name__ == "__main__":
    main()
