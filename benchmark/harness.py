"""The benchmark's harness: one run of one cell.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its kind, whose
driver (``drivers/<kind>.py``) builds the inputs and weights from the seed
and sends one request (or one training step) through the program's public
entry. Limits of the correctness check are ``limits/<cell>.json``; each
metric has a reader, ``metrics/<metric>.py``. Nothing here names a cell,
a configuration, a mix or a metric: a new one is new files and entries.

A run: set-up (torch, CUDA, weights, inputs, kernels, the warm-up of every
shape the cell uses), then a closed loop of whole requests from one caller
for at least ``--seconds``, then the check against the reference, then the
result's line. With ``--trace 1`` a second window of the same length follows
the first under ``torch.profiler``: the metrics taken from the device's
trace read it, the others the first, which the profiler does not slow.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "must3r_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A file of the benchmark as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """Everything one cell runs with, found by name."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(ROOT / cfg_entry["file"]),
                traffic=load_json(BENCH_DIR / "traffic"
                                  / f"{w['traffic']}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def driver_class(cell: Cell):
    return load_module(BENCH_DIR / "drivers" /
                       f"{cell.traffic['kind']}.py").Driver


@dataclass
class Context:
    """What a metric's reader reads: one window of the run."""
    cell: Cell
    setup_s: float
    window_s: float
    requests: int
    units: int
    work: object                  # work.Work of the whole window
    peak_bytes: int
    trace: object = None          # trace.Trace of the window, or None


def metric_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a
    metric split by cell kind (``<quantity>.<kind>``) the quantity's own
    ``metrics/<quantity>.py``."""
    for stem in dict.fromkeys((name, name.split(".")[0])):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path).read
    raise FileNotFoundError(f"no reader of metric {name!r} in "
                            f"{BENCH_DIR / 'metrics'}")


def read_metrics(metrics: List[dict], host: Context,
                 traced: Optional[Context] = None) -> dict:
    """Each metric read from its window: a ``device_trace`` metric from the
    traced window, every other from the untraced one, which the profiler
    does not slow."""
    out = {}
    for m in metrics:
        ctx = traced if m.get("source") == "device_trace" else host
        if ctx is None:
            continue
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def _query(cmd: List[str]) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    return out.stdout.strip() or out.stderr.strip()


def card_state() -> str:
    return _query(["nvidia-smi", "--query-gpu=index,name,power.limit,"
                   "clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
                   "--format=csv,noheader"])


def versions() -> dict:
    import torch
    nvcc = _query(["nvcc", "--version"]).splitlines()
    return {"device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc[-1] if nvcc else "", "python": sys.version.split()[0]}


@dataclass
class Window:
    requests: int
    units: int
    ends: List[float]             # each request's end, from the start

    @property
    def seconds(self) -> float:
        return self.ends[-1]


def run_window(driver, seconds: float, first: int = 0,
               min_requests: int = 1) -> Window:
    """Whole requests back to back from one caller until ``seconds`` have
    passed (and at least ``min_requests`` have ended)."""
    units = requests = 0
    ends = []
    t0 = time.perf_counter()
    while True:
        units += driver.request(first + requests)
        requests += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds and requests >= min_requests:
            return Window(requests, units, ends)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             driver_cls=None, log=print, min_requests: int = 1) -> dict:
    """One run; returns the result's dict (its ``checks`` last). On a CPU
    ``device`` it runs as on the card but reads no card state (tests)."""
    import torch

    from benchmark import trace as trace_mod

    t_start = time.time() if t_start is None else t_start
    on_card = device.startswith("cuda")
    driver = (driver_cls or driver_class(cell))(cell.config, cell.traffic,
                                                seed, torch.device(device))
    driver.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        log(json.dumps({"versions": versions(), "card_before": card_state()}))
    setup_s = time.time() - t_start
    host = run_window(driver, seconds, min_requests=min_requests)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    traced = tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.start()
        with record_function(trace_mod.WINDOW):
            traced = run_window(driver, seconds, first=host.requests)
        prof.stop()
        tr = trace_mod.reduce_profile(prof)
        del prof
    requests = host.requests + (traced.requests if traced else 0)
    peak_all = torch.cuda.max_memory_allocated() if on_card else 0
    t_window = time.time()
    if on_card:
        log(json.dumps({"card_after": card_state(),
                        "counters": driver.counters(),
                        "requests": host.requests, "window_s": host.seconds,
                        "request_s": [b - a for a, b in
                                      zip([0.0] + host.ends, host.ends)],
                        **({"traced_requests": traced.requests,
                            "traced_window_s": tr.window_s}
                           if traced else {})}))

    def context(w: Window, window_s: float, tr=None) -> Context:
        return Context(cell=cell, setup_s=setup_s, window_s=window_s,
                       requests=w.requests, units=w.units,
                       work=driver.work().scaled(w.requests),
                       peak_bytes=peak, trace=tr)
    metrics = read_metrics(
        cell.per_layer if trace else cell.end_to_end,
        context(host, host.seconds),
        context(traced, tr.window_s, tr) if traced else None)
    numbers = driver.check()
    del driver
    gc.collect()
    log(json.dumps({"check_s": time.time() - t_window,
                    "numbers": numbers}))
    checks, correct = {}, True
    missing = set(cell.limits) - set(numbers)
    if missing:
        raise RuntimeError(f"limits of numbers the check does not give: "
                           f"{sorted(missing)}")
    for name, limit in cell.limits.items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
        correct &= math.isfinite(value) and value <= limit
    result = {"correct": bool(correct), "attempted": requests, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": peak_all}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
