"""Synthetic data (the port's copy of ``repro.data``)."""
from repro_torch.data.pipeline import make_batch, make_eval_batch  # noqa: F401
