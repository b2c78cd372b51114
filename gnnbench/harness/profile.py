"""The profiler reader: a ``torch.profiler`` trace of some steps, reduced to
device operations with their times, the harness's host spans, the device's
busy time and idle gaps.

It reads the trace's events themselves (the exported Chrome trace), not
``key_averages()``: the idle share and the gaps need each operation's start
and end, and a gap is labelled by the host span in which the operation that
ends it was launched (a launch and its kernel share a correlation id).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("forward", "loss", "backward", "optimizer")
TOP = 10


class Profile:
    """Device operations (name, start µs, duration µs) of ``steps`` steps,
    and the host spans (name, start µs, end µs) around the harness's calls."""

    def __init__(self, ops: List[Tuple[str, float, float]], spans, launches: Dict[int, float],
                 op_corr: List[Optional[int]], steps: int):
        order = sorted(range(len(ops)), key=lambda i: ops[i][1])
        self.ops = [ops[i] for i in order]
        self.op_corr = [op_corr[i] for i in order]
        self.spans = sorted(spans, key=lambda s: s[1])
        self.launches = launches
        self.steps = steps

    @property
    def window_s(self) -> float:
        """From the first device operation's start to the last one's end."""
        if not self.ops:
            return 0.0
        return (max(s + d for _, s, d in self.ops) - self.ops[0][1]) / 1e6

    def _busy_intervals(self):
        merged = []
        for _, s, d in self.ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the operations' intervals)."""
        return sum(e - s for s, e in self._busy_intervals()) / 1e6

    def device_ms_per_step(self, names) -> Optional[float]:
        """Device ms per step of the operations whose name holds one of
        ``names`` (case-insensitive); None when there is none."""
        keys = [n.lower() for n in names]
        hit = [d for n, _, d in self.ops if any(k in n.lower() for k in keys)]
        return sum(hit) / 1e3 / self.steps if hit else None

    def top_ops(self, top: int = TOP):
        total: Dict[str, float] = {}
        for n, _, d in self.ops:
            total[n] = total.get(n, 0.0) + d / 1e6
        return sorted(([n, s] for n, s in total.items()), key=lambda x: -x[1])[:top]

    def _span_at(self, t: float) -> str:
        label = "between_steps"
        for name, s, e in self.spans:
            if s > t:
                break
            if t <= e:
                label = name
        return label

    def idle_gaps(self, top: int = TOP):
        """The longest idle stretches of the device, each labelled with the
        harness span the host was in when it launched the operation that
        ended the stretch (its launch time; the gap's end without one)."""
        starts = {}
        for (_, s, _), corr in zip(self.ops, self.op_corr):
            starts.setdefault(s, corr)
        gaps = []
        intervals = self._busy_intervals()
        for prev, nxt in zip(intervals, intervals[1:]):
            corr = starts.get(nxt[0])
            t = self.launches.get(corr, nxt[0]) if corr is not None else nxt[0]
            gaps.append([self._span_at(t), (nxt[0] - prev[1]) / 1e6])
        return sorted(gaps, key=lambda g: -g[1])[:top]


def read_chrome_trace(path: str, steps: int) -> Profile:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ops, op_corr, spans, launches = [], [], [], {}
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph != "X":
            continue
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0))))
            op_corr.append(args.get("correlation"))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name") in SPANS:
            spans.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
    return Profile(ops, spans, launches, op_corr, steps)


def profile_steps(step, steps: int, synchronize) -> Profile:
    """Profiles ``steps`` calls of ``step(span)`` back to back, the harness's
    spans recorded around its calls, and reads the trace. The trace goes to
    a temporary file, removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    synchronize()
    with profile(activities=activities) as prof:
        for _ in range(steps):
            step(record_function)
        synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, steps)
    finally:
        os.remove(path)
