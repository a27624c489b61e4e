"""Model FLOPs of the untraced window's requests (a training step: encoder
forward, decoder 3 x forward) over that window, as a share of the dense
bf16 peak (%)."""

from benchmark.readers import mfu as read  # noqa: F401
