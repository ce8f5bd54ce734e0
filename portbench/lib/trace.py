"""The traced run's reading of ``torch.profiler``: the device's busy time
inside the window, the kernels' time by name, and the longest idle gaps by
what the host was doing.

The window is a ``record_function`` range (``MARK``) that the driver opens
at the window's start and closes at its end; only device events (kernels,
copies, sets) inside it count, clipped to it.  ``classify`` is a copy of
``tools/profile_engine_cuda.py::classify``: the group of a device event by
the words of its name.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

MARK = "portbench window"
HAND_WRITTEN = ("shift_windows", "def_windows", "peakfit", "corrfit", "fused_pass")
NAME_CHARS = 60  # a name in the breakdown is cut here
TOP = 10


def classify(name: str) -> str:
    """The group of a device event's name; the hand-written kernels under
    their own names.  The function's name decides, not its template
    arguments."""
    n = name.lower().split("<")[0]
    for word in HAND_WRITTEN:
        if word in n:
            return word
    if "memcpy" in n and ("htod" in n or "dtoh" in n):
        return "transfer"
    if "memcpy" in n or "memset" in n or "copy" in n or "transpose" in n \
            or "roll_cuda" in n:
        return "layout_copy"
    if "fft" in n:
        return "fft"
    if "gemm" in n or "gemv" in n or "sm90" in n or "cutlass" in n:
        return "matmul"
    if "reduce" in n or "argmax" in n or "sort" in n or "scan" in n:
        return "reduce"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather_scatter"
    if "elementwise" in n or "vectorized" in n:
        return "fusion"
    return "other"


class Tracer:
    """``torch.profiler`` over set-up's end and the window; ``open`` and
    ``close`` bracket the window with ``MARK``."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts)
        self.range = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.close()
        self.prof.__exit__(*exc)
        return False

    def open(self):
        from torch.autograd.profiler import record_function

        self.range = record_function(MARK)
        self.range.__enter__()

    def close(self):
        r, self.range = self.range, None
        r.__exit__(None, None, None)

    def events(self) -> List[Tuple[str, bool, float, float]]:
        """``(name, on_device, start_us, end_us)`` of every event."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            out.append((e.name(), e.device_type() == DeviceType.CUDA,
                        start, start + e.duration_ns() / 1e3))
        return out


def summarize(events) -> Optional[Dict]:
    """The window's ``window_s``, ``busy_s``, kernel seconds and counts by
    name, and the breakdown; None where the window left no mark."""
    marks = [e for e in events if e[0] == MARK and not e[1]]
    if not marks:
        return None
    w0, w1 = marks[0][2], marks[0][3]
    dev, host = [], []
    for name, on_dev, s, e in events:
        if name == MARK:
            continue
        if on_dev:
            if e > w0 and s < w1:
                dev.append((max(s, w0), min(e, w1), name))
        elif e > w0 and s < w1:
            host.append((s, e, name))
    dev.sort()
    seconds = collections.Counter()
    counts = collections.Counter()
    groups = collections.Counter()
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    for s, e, name in dev:
        seconds[name] += (e - s) / 1e6
        counts[name] += 1
        groups[f"{classify(name)}:{name[:NAME_CHARS]}"] += (e - s) / 1e6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    else:
        gaps.append((w0, w1))
    idle = collections.Counter()
    host.sort()
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        idle[_host_at(host, starts, (g0 + g1) / 2)] += (g1 - g0) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "kernel_s": dict(seconds), "kernel_n": dict(counts),
            "breakdown": {"device_ops": [[k, v] for k, v in groups.most_common(TOP)],
                          "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)]}}


def _host_at(host, starts, t, look_back: int = 200) -> str:
    """The innermost host operation running at ``t``: of those that began
    before it and end after it, the latest to begin."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - look_back), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "no_host_op_recorded"


def kernel_time(trace: Dict, words) -> Tuple[float, int]:
    """Seconds and launches of the kernels whose name (before its template
    arguments) holds one of ``words``."""
    s, n = 0.0, 0
    for name, sec in trace["kernel_s"].items():
        if any(w in name.split("<")[0] for w in words):
            s += sec
            n += trace["kernel_n"][name]
    return s, n
