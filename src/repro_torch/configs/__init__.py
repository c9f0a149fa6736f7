"""Scheduling configuration (the port's copy of ``repro.configs``)."""
