"""Device operations in the traced window per step completed."""

from benchmark.readers import launches_per_unit as read  # noqa: F401
