"""Launchers (the port's copy of ``repro.launch``)."""
