"""Named workloads for the port: so far the paper's own §4.2
generator, ``paper-synthetic``."""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from repro_torch.configs.cluster import SimConfig
from repro_torch.core import workload
from repro_torch.core.types import JobSet

_SCENARIOS: Dict[str, Callable[[SimConfig], JobSet]] = {
    "paper-synthetic": workload.generate,
}


def scenario_names() -> List[str]:
    return sorted(_SCENARIOS)


def build(name: str, cfg: SimConfig) -> JobSet:
    """Build and validate the named scenario's JobSet for ``cfg``."""
    try:
        fn = _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{', '.join(scenario_names())}") from None
    js = fn(cfg)
    js.validate(np.asarray(cfg.cluster.node.as_tuple()))
    return js
