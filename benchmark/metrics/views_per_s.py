"""Views reconstructed and fetched to the host over the whole window, per
second."""

from benchmark.readers import units_per_s as read  # noqa: F401
