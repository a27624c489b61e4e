"""Set-up time: from the process's start to the window's start, compile and
warm-up included (s)."""

from benchmark.readers import setup_s as read  # noqa: F401
