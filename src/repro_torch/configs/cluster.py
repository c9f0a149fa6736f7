"""Cluster + workload configuration for the FitGpp simulation (paper §4).

The port's copy of ``repro.configs.cluster``: same fields and defaults,
except that ``SimConfig`` has no ``score_backend`` (in the port the
tensors' device decides between the CUDA kernel and its plain PyTorch
version). The node shape and the exec-time / GP distributions are the
paper's; the per-class resource demands are the JAX package's
documented choices (the paper's trace is private).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.configs.base import PAPER_P, PAPER_S


@dataclass(frozen=True)
class NodeSpec:
    """One node: capacities for (CPU cores, RAM GB, GPUs). Paper §4.1."""
    cpu: float = 32.0
    ram: float = 256.0
    gpu: float = 8.0

    def as_tuple(self) -> Tuple[float, float, float]:
        return (self.cpu, self.ram, self.gpu)


@dataclass(frozen=True)
class ClusterSpec:
    n_nodes: int = 84                 # paper §4.1
    node: NodeSpec = field(default_factory=NodeSpec)


@dataclass(frozen=True)
class TruncNormal:
    """Normal(mean, std) truncated to [lo, hi]; sampled by resampling."""
    mean: float
    std: float
    lo: float
    hi: float


@dataclass(frozen=True)
class ClassDists:
    """Per-class (TE or BE) job distributions."""
    exec_min: TruncNormal             # execution time [minutes]
    cpu: TruncNormal
    ram: TruncNormal
    gpu: TruncNormal


@dataclass(frozen=True)
class WorkloadSpec:
    """Synthetic workload per paper §4.2 (exec-time means/truncations
    and the GP distribution are the paper's; demands are the JAX
    package's calibrated choices)."""
    n_jobs: int = 2 ** 16
    te_fraction: float = 0.30         # paper: ~30% of jobs are TE
    load: float = 2.0                 # FIFO-normalized cluster load
    te: ClassDists = field(default_factory=lambda: ClassDists(
        exec_min=TruncNormal(5.0, 5.0, 1.0, 30.0),
        cpu=TruncNormal(4.0, 4.0, 1.0, 32.0),
        ram=TruncNormal(16.0, 16.0, 1.0, 256.0),
        gpu=TruncNormal(5.0, 2.5, 0.0, 8.0),
    ))
    be: ClassDists = field(default_factory=lambda: ClassDists(
        exec_min=TruncNormal(30.0, 30.0, 3.0, 1440.0),
        cpu=TruncNormal(8.0, 6.0, 1.0, 32.0),
        ram=TruncNormal(48.0, 48.0, 1.0, 256.0),
        gpu=TruncNormal(3.0, 2.5, 0.0, 8.0),
    ))
    gpu_quanta: Tuple[float, ...] = (0.0, 1.0, 2.0, 4.0, 8.0)
    # GP ~ N(3, 3) truncated [0, 20] minutes (paper: mean 3, trunc 20).
    gp_min: TruncNormal = field(
        default_factory=lambda: TruncNormal(3.0, 3.0, 0.0, 20.0))
    gp_scale: float = 1.0             # Fig. 7 sweeps {1, 2, 4, 8}
    # Gang jobs (beyond the paper): the fraction of jobs that are gangs,
    # widths drawn from multi_node_widths. 0.0 = the paper's model.
    multi_node_frac: float = 0.0
    multi_node_widths: Tuple[int, ...] = (2, 4)

    def scaled_gp(self) -> TruncNormal:
        s = self.gp_scale
        g = self.gp_min
        return TruncNormal(g.mean * s, g.std * s, g.lo, g.hi * s)


@dataclass(frozen=True)
class SimConfig:
    cluster: ClusterSpec = field(default_factory=ClusterSpec)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    policy: str = "fitgpp"            # any policy of the port's table
    s: float = PAPER_S                # Eq. 3 GP weight
    max_preemptions: int = PAPER_P    # P (paper uses 1; Fig. 5 sweeps)
    seed: int = 0
    tick_minutes: float = 1.0
    time_mode: str = "event"          # "event" | "tick", bit-identical
    # Bounded first-fit BE backfill (beyond the paper): queued BE jobs
    # behind a blocked head start when they fit, at most backfill_depth
    # blocked jobs skipped a pass.
    backfill: bool = False
    backfill_depth: int = 64

    def __post_init__(self):
        from repro_torch.core.policy_registry import validate_config
        validate_config(self.policy, self.s, self.max_preemptions)
        if self.time_mode not in ("tick", "event"):
            raise ValueError(f"unknown time_mode {self.time_mode!r}; "
                             "one of ('tick', 'event')")
