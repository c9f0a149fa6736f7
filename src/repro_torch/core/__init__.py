"""The port's scheduler core: types, workload, policies, engine."""
