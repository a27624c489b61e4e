"""What the metric readers (``metrics/<name>.py``) compute from a run's
context (``harness.Context``). A reader that finds nothing to read returns
None, and the metric is left out of the result."""

from __future__ import annotations

from benchmark import trace as trace_mod
from benchmark.work import PEAK_FLOPS

GIB = 2 ** 30


def setup_s(ctx):
    return ctx.setup_s


def units_per_s(ctx):
    """Every unit (view, step) completed over the whole window."""
    return ctx.units / ctx.window_s


def idle_share(ctx):
    """100 x (1 - the union of the device's activity / the window)."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def mfu(ctx):
    """100 x the model FLOPs of the window's requests / the window / the
    dense bf16 peak."""
    return 100.0 * ctx.work.flops / ctx.window_s / PEAK_FLOPS


def _roofline(ctx, least_s, groups):
    if ctx.trace is None:
        return None
    secs = ctx.trace.group_seconds()
    busy = sum(secs.get(g, 0.0) for g in groups)
    if busy <= 0.0 or least_s <= 0.0:
        return None
    return 100.0 * least_s / busy


def ca_fwd_roofline(ctx):
    """100 x the least time of every memory CA forward in the window / the
    device time of the kernels that ran them (K2, K2(d), K6)."""
    return _roofline(ctx, ctx.work.ca_fwd_s, trace_mod.CA_FORWARD)


def ca_bwd_roofline(ctx):
    """The same for the CA backward (K3, K4, K5)."""
    return _roofline(ctx, ctx.work.ca_bwd_s, trace_mod.CA_BACKWARD)


def launches_per_unit(ctx):
    """Device operations (kernels, copies, memsets) in the trace / units."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.units


def peak_mem_gib(ctx):
    return ctx.peak_bytes / GIB if ctx.peak_bytes else None
