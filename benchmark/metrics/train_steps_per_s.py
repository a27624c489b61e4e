"""Optimizer steps completed over the whole window, per second."""

from benchmark.readers import units_per_s as read  # noqa: F401
