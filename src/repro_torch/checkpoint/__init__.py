"""Train-state checkpoints (the port's copy of ``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (estimate_grace_period, load_pytree,
                                         load_tree, save_pytree, state_bytes)

__all__ = ["save_pytree", "load_pytree", "load_tree", "state_bytes",
           "estimate_grace_period"]
