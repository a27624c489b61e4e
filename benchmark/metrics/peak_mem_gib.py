"""Peak device memory allocated during the untraced window (GiB)."""

from benchmark.readers import peak_mem_gib as read  # noqa: F401
