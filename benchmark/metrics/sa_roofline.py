"""Least time of the traced window's K1 self-attentions over the device
time of K1 (%)."""

from benchmark.readers import _roofline


def read(ctx):
    least = getattr(ctx.work, "sa_s", 0.0)
    return _roofline(ctx, least, ("K1 sa_fwd",)) if least else None
