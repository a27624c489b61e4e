"""Device operations in the traced window per view completed."""

from benchmark.readers import launches_per_unit as read  # noqa: F401
