"""The device's idle share of the traced window (%): 1 - the union of its
activity (kernels, copies, memsets) over the window."""

from benchmark.readers import idle_share as read  # noqa: F401
