"""The benchmark's one command, from the root of a checkout that holds
the program (``must3r_tpu_torch``), on a machine with an NVIDIA card:

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

See ``benchmark/README.md``.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def process_start() -> float:
    """When this process started (its start in /proc, where there is one)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return min(T_START, btime + ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, StopIteration):
        return T_START


ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# every compile cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ.setdefault("USE_FLAX", "0")
# the host's CPU work from one process with few threads: steadier runs
os.environ["OMP_NUM_THREADS"] = "4"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from benchmark.harness import main
    sys.exit(main(t_start=process_start()))
