"""Named workloads for the port: the paper's own generators, the
library of synthetic stress scenarios and the Philly-style and
Alibaba-PAI-style trace adapters with their bundled sample fixtures,
under the JAX package's registry names.

    from repro_torch import scenarios
    js = scenarios.build("burst-storm", cfg)     # SimConfig -> JobSet
    scenarios.scenario_names()                   # all registered names
"""
from repro_torch.scenarios.registry import (SYNTHETIC, TRACE, Scenario,
                                            all_scenarios, build,
                                            get_scenario, get_source,
                                            register_scenario,
                                            scenario_names)
# importing these modules populates the registry
from repro_torch.scenarios import library as library      # noqa: F401
from repro_torch.scenarios import traces as traces        # noqa: F401
from repro_torch.scenarios.traces import (TraceStats, iter_trace_csv,
                                          load_pai_csv, load_philly_csv)

__all__ = [
    "SYNTHETIC", "TRACE", "Scenario", "TraceStats",
    "all_scenarios", "build", "get_scenario", "get_source",
    "iter_trace_csv", "library", "load_pai_csv", "load_philly_csv",
    "register_scenario", "scenario_names", "traces",
]
