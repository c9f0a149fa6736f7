"""InternVL2-2B [vlm]: an InternLM2-style GQA decoder reading projected
visual tokens (counterpart of ``repro.models.vlm``).

The InternViT vision tower is the one allowed stub: ``make_batch``
supplies patch embeddings (B, n_visual, d_visual); the 2-layer MLP
projector (``w1`` (d_visual, D), ``b1``, ``w2`` (D, D), ``b2``; GELU in
``jax.nn.gelu``'s tanh form) and the whole language model are real.
:class:`VisionLM` is a ``DenseLM`` with the projector's leaves in
``projector``, an unstacked dict of the definitions.

Sequence layout: [visual prefix | text tokens] under one causal mask
over the whole sequence; loss on the text only. Decode is the dense
``serve_step`` (the visual prefix lives in the cache after prefill).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, dense
from repro_torch.models.common import ParamDef


def param_defs(cfg: ModelConfig) -> dict:
    defs = dense.param_defs(cfg)
    dv, D = cfg.vlm.d_visual, cfg.d_model
    defs["projector"] = {
        "w1": ParamDef((dv, D), ("state", "embed")),
        "b1": ParamDef((D,), ("embed",), init="zeros"),
        "w2": ParamDef((D, D), ("embed", "embed")),
        "b2": ParamDef((D,), ("embed",), init="zeros"),
    }
    return defs


class VisionLM(dense.DenseLM):
    """A ``DenseLM`` plus ``projector``, the projector's four leaves."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.projector = dense._Leaves(
            param_defs(cfg)["projector"], common.torch_dtype(cfg.dtype),
            device, stacked=False)

    def leaf(self, name: str, layer: Optional[int] = None,
             stack: str = "layers") -> nn.Parameter:
        """As ``DenseLM.leaf``; ``stack="projector"`` names a projector
        leaf."""
        if stack == "projector":
            return getattr(self.projector, name)
        return super().leaf(name, layer, stack)


LM = VisionLM


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> VisionLM:
    """Random parameters with the JAX package's initializers, drawn leaf
    by leaf by ``dense.init_leaves`` from ``seed``, the same bits on
    every device; the numbers differ from ``jax.random``'s."""
    dev = _device.resolve(device)
    return dense.init_leaves(VisionLM(cfg, device=dev), param_defs(cfg),
                             seed, dev)


def project(cfg: ModelConfig, model: VisionLM,
            visual: torch.Tensor) -> torch.Tensor:
    """(B, n_vis, d_visual) -> (B, n_vis, D) visual prefix tokens."""
    pp = model.projector
    h = visual.to(common.torch_dtype(cfg.dtype)) @ pp.w1 + pp.b1
    return common.activate(h, "gelu") @ pp.w2 + pp.b2


def _embed_multimodal(cfg: ModelConfig, model: VisionLM,
                      batch: dict) -> torch.Tensor:
    prefix = project(cfg, model, batch["visual_embeds"])
    text = dense.embed(cfg, model, batch["tokens"])
    return torch.cat([prefix, text], dim=1)


@torch.no_grad()
def forward(cfg: ModelConfig, model: VisionLM, batch: dict) -> torch.Tensor:
    """-> logits over the FULL sequence (visual positions included)."""
    x = dense.hidden_embedded(cfg, model, _embed_multimodal(cfg, model,
                                                            batch))
    return dense.unembed(cfg, model, x)


def loss_fn(cfg: ModelConfig, model: VisionLM, batch: dict) -> torch.Tensor:
    """Next-token CE on the text region only (text token t+1 predicted
    from position n_visual + t), float32 0-d, differentiable through
    the training route."""
    nv = cfg.vlm.n_visual_tokens
    x = dense.hidden_embedded(cfg, model, _embed_multimodal(cfg, model,
                                                            batch),
                              train=True)
    logits = dense.unembed(cfg, model, x)
    return common.cross_entropy(logits[:, nv:-1], batch["tokens"][:, 1:])


@torch.no_grad()
def prefill(cfg: ModelConfig, model: VisionLM, batch: dict,
            pad_to: int = 0) -> Tuple[torch.Tensor, dict]:
    """Prefill the visual prefix and the text prompt; (last-position
    logits, cache)."""
    return dense.prefill_embedded(cfg, model,
                                  _embed_multimodal(cfg, model, batch),
                                  pad_to)


init_decode_cache = dense.init_decode_cache
serve_step = dense.serve_step   # text-token decode is the dense one
