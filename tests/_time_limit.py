"""A hard time limit for every test, with no plugin beyond pytest itself.

A test's limit is the seconds of its ``timeout(seconds)`` marker, or
``DEFAULT_LIMIT_S`` when it has none. The limit covers the test's setup, call
and teardown. ``faulthandler``'s watchdog thread is armed before setup and
cancelled after teardown; a test still running at its limit makes the process
dump every thread's stack to stderr and exit. The watchdog is a C thread that
needs no GIL, so it fires even when the test is stuck inside native code.

Under xdist the controller reports that one test as failed ("worker 'gwN'
crashed while running ..."), hands the rest of the dead worker's queue back
to the pool and starts a new worker, so a hang costs one test and its limit.
Without xdist the run stops at the hung test.

The conftest imports the hook; another test directory can load it with
``-p _time_limit`` when this directory is on ``sys.path``.
"""

import faulthandler
import os

import pytest

# About 3x the slowest unmarked test of a clean tier-1 run (57 s, setup
# included, on 8 CPU cores with 6 xdist workers).
DEFAULT_LIMIT_S = 180.0

_STDERR_FD = pytest.StashKey[int]()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    stash = item.config.stash
    if _STDERR_FD not in stash:
        # Outside a test's phases pytest's capture is suspended, so fd 2 is
        # the process's stderr here; while a test runs it may point at a
        # capture file, and the dump would be lost there.
        stash[_STDERR_FD] = os.dup(2)
    marker = item.get_closest_marker("timeout")
    limit = DEFAULT_LIMIT_S if marker is None else float(marker.args[0])
    faulthandler.dump_traceback_later(limit, exit=True,
                                      file=stash[_STDERR_FD])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
