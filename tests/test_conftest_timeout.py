"""The per-test time limit of ``_time_limit.py``, run as its own pytest.

A child pytest on a temporary directory loads the hook with ``-p
_time_limit`` and runs five tests on two xdist workers under ``--dist load``
(what the tier-1 run uses). The first test sleeps 30 s under a
``timeout(3)`` marker; the four after it are quick, and the one right behind
the sleeper is queued on the sleeper's worker. The sleeper must be reported
failed long before its sleep would end, and the other four must still pass.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

TESTS = Path(__file__).resolve().parent

_CONFTEST = '''
def pytest_configure(config):
    config.addinivalue_line("markers", "timeout(seconds): hard time limit")
'''

_TESTS = '''
import os
import time

import pytest


@pytest.mark.timeout(3)
def test_a_sleeper():
    with open(os.environ["SLEEPER_STARTED"], "w") as f:
        f.write(repr(time.time()))
    time.sleep(30)


@pytest.mark.parametrize("i", range(4))
def test_b_quick(i):
    assert i >= 0
'''


def test_a_test_past_its_limit_fails_and_its_queue_still_runs(tmp_path):
    (tmp_path / "conftest.py").write_text(_CONFTEST)
    (tmp_path / "test_limit.py").write_text(_TESTS)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "XLA_", "JAX_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(TESTS)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env["SLEEPER_STARTED"] = str(tmp_path / "started")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "_time_limit", "-p", "xdist", "-n", "2",
         "--dist", "load", "-rf", "--rootdir", str(tmp_path),
         str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=55)
    took = time.time() - float((tmp_path / "started").read_text())
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "1 failed, 4 passed" in out, out
    assert "FAILED test_limit.py::test_a_sleeper" in out, out
    assert "crashed while running" in out, out
    # faulthandler's dump names the limit it fired at.
    assert "Timeout (0:00:03)!" in out, out
    # From the sleeper's start to the run's end: 3 s of limit, a new
    # worker's start-up and the rest of the run. The sleep alone takes 30 s.
    assert took < 3 + 15, (took, out)
