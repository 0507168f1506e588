"""Resilience utilities of the port; only ``faults`` is ported so far."""
