"""Reduction of a ``torch.profiler`` trace of the measured window, in
memory: the device's activities (kernels, copies, memsets) and the host's
operations, as plain tuples, and what the per-layer readers take from
them.

Device time is the union of the device activities' intervals; an idle gap
is a stretch between two of them, labelled by the innermost host
operation that was running at its middle. Kernels are grouped by their
demangled names with the patterns of the program's own kernels (the
port's ``tools/profile_offline.py::KERNEL_GROUPS``, copied here).
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# the program's attention kernels by demangled name: K1 (self-attention),
# K2 (memory CA, bf16; flags CA, STATS, EXT), K2(d) (the 8-bit memory:
# QUANT 1 int8, 2 fp8), K6 (head pairs, HP = 2), K5 / K4 (key-block
# backward, DQ true / false), K3 (query-block backward), K7 (LayerNorm +
# matmul)
KERNEL_GROUPS = (
    ("K1 sa_fwd", r"attn_fwd_sm90<false"),
    ("K6 ca_fwd_2h", r"attn_fwd_sm90<true, \w+, \w+, 0, \d+, 2>"),
    ("K2 ca_fwd", r"attn_fwd_sm90<true, \w+, \w+, 0,"),
    ("K2(d) ca_fwd_q8 int8", r"attn_fwd_sm90<true, \w+, \w+, 1,"),
    ("K2(d) ca_fwd_q8 fp8", r"attn_fwd_sm90<true, \w+, \w+, 2,"),
    ("K5 ca_bwd_fused", r"ca_bwd_fused_sm90<\w+, true>"),
    ("K4 ca_bwd_dkv", r"ca_bwd_fused_sm90<\w+, false>"),
    ("K3 ca_bwd_dq", r"ca_bwd_dq_sm90<"),
    ("K7 ln_matmul", r"ln_matmul_sm90<"))
CA_FORWARD = ("K2 ca_fwd", "K2(d) ca_fwd_q8 int8", "K2(d) ca_fwd_q8 fp8",
              "K6 ca_fwd_2h")
CA_BACKWARD = ("K5 ca_bwd_fused", "K4 ca_bwd_dkv", "K3 ca_bwd_dq")


def kernel_group(name: str) -> Optional[str]:
    for group, pattern in KERNEL_GROUPS:
        if re.search(pattern, name):
            return group
    return None


def _ns(ev, what: str) -> int:
    """An event's start or end in ns (older profilers give microseconds)."""
    if hasattr(ev, "start_ns"):
        start = ev.start_ns()
        return start if what == "start" else start + ev.duration_ns()
    start = ev.start_us() * 1000
    return start if what == "start" else start + ev.duration_us() * 1000


@dataclass
class Trace:
    device: List[Tuple[int, int, str]]        # (start ns, end ns, name)
    host: List[Tuple[int, int, str]]
    t0_ns: int
    t1_ns: int

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for a, b, _ in sorted(self.device):
            a, b = max(a, self.t0_ns), min(b, self.t1_ns)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def group_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for a, b, name in self.device:
            group = kernel_group(name)
            if group is not None:
                out[group] += (b - a) / 1e9
        return dict(out)

    def top_device_ops(self, k: int = 10) -> List[list]:
        acc: Dict[str, float] = defaultdict(float)
        for a, b, name in self.device:
            acc[name] += (b - a) / 1e9
        return [[name[:160], s] for name, s in
                sorted(acc.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The idle time between device activities, summed by the
        innermost host operation running at each gap's middle (the first
        gap from the window's start, the last to its end)."""
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for ab in busy for x in ab] + [self.t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host)
        heap: list = []
        j = 0
        acc: Dict[str, float] = defaultdict(float)
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) // 2
            while j < len(host) and host[j][0] <= mid:
                heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
                j += 1
            while heap and heap[0][1] <= mid:
                heapq.heappop(heap)
            label = heap[0][2] if heap else "(no host operation)"
            acc[label] += (b - a) / 1e9
        return [[name[:160], s] for name, s in
                sorted(acc.items(), key=lambda kv: -kv[1])[:k]]


WINDOW = "bench.window"


def reduce_profile(prof) -> Trace:
    """The events of a stopped ``torch.profiler.profile`` as a Trace,
    without the profiler's own event tables (which take minutes to build
    for a window of a million events). The window is the host range named
    ``WINDOW`` (``torch.profiler.record_function``), in the trace's own
    clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    t0 = t1 = None
    for ev in prof.profiler.kineto_results.events():
        row = (_ns(ev, "start"), _ns(ev, "end"), ev.name())
        on_device = ev.device_type() == cuda
        if row[2] == WINDOW:
            if not on_device:
                t0, t1 = row[0], row[1]
        elif on_device:
            # a host range's shadow on the device is no device activity
            if not (hasattr(ev, "is_user_annotation")
                    and ev.is_user_annotation()):
                device.append(row)
        else:
            host.append(row)
    if t0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    return Trace(device=device, host=host, t0_ns=t0, t1_ns=t1)
