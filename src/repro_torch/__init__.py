"""PyTorch/CUDA port of the FitGpp scheduling engine.

A package of its own beside the JAX package ``repro``: it imports
``torch`` and numpy only, and keeps its own copy of every host module
it needs. Module names mirror the JAX package's so each counterpart is
easy to find (``core/sim_jax.py`` -> ``core/sim_torch.py``,
``kernels/schedule_step.py`` -> ``kernels/schedule_step.py`` with a
hand-written CUDA kernel under ``kernels/csrc/``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU and without an explicit device they
raise instead of falling back (see :func:`repro_torch.device.resolve`).
"""
