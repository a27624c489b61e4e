"""Least time of the traced window's memory cross-attention backwards over
the device time of K3, K4, K5 (%)."""

from benchmark.readers import ca_bwd_roofline as read  # noqa: F401
