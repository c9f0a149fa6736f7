"""The port's counterparts of the JAX package's ``examples/*.py``.

Each is a module with ``main(argv=None)`` that prints its report and
returns the text it printed, run as ``python -m
repro_torch.examples.<name>``. Each takes ``--device``, which defaults to
the current CUDA device and raises without one (``device.resolve``):
pass ``--device cpu`` to run the plain PyTorch path on the CPU. Where
the JAX example hard-codes a size, ``main`` takes it as a keyword
argument whose default is the JAX value. Importing an example runs
nothing.

* ``cluster_simulation``: the paper's Tables 1–3;
* ``trace_replay``: the Philly- and PAI-style fixtures with telemetry;
* ``stream_replay``: a bounded-memory replay through the stream engine;
* ``distributed_sweep``: Fig. 4's grid through the sweep fabric;
* ``quickstart``: FitGpp against FIFO, train steps, a live preemption;
* ``preemptible_training``: a four-job fleet under the live controller;
* ``train_100m``: a ~100M-parameter dense model for 300 steps.
"""
