"""Least time of the traced window's memory cross-attention forwards over
the device time of K2 / K2(d) (%)."""

from benchmark.readers import ca_fwd_roofline as read  # noqa: F401
