"""Readings of the port's own spans and counters
(``tf_geometric_tpu_torch.utils.profiling``), for ``gnnbench/port_report.py``.

A span here is the port's ``Span``: ``name``, ``start_ns``, ``end_ns`` (None
while open), ``parent`` (an index into the same list, or None) and
``thread``. ``profile_steps`` profiles steps as ``harness.profile`` does and
keeps, besides, the port's ``tfg.*`` annotations and each launch's thread,
so that ``PortProfile.idle_gaps_by_span`` can label a gap with the port
call that launched the operation ending it.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence

from gnnbench.harness import profile

PORT_PREFIX = "tfg."


def since(spans: Sequence, first: int) -> list:
    """The spans from index ``first`` on, their parents indexed in the
    returned list (a parent before ``first`` becomes None)."""
    return [s._replace(parent=None if s.parent is None or s.parent < first
                       else s.parent - first) for s in spans[first:]]


def _closed(spans: Sequence, prefixes: Iterable[str]) -> List[int]:
    prefixes = tuple(prefixes)
    return [i for i, s in enumerate(spans) if s.end_ns is not None and s.name.startswith(prefixes)]


def outer_ns(spans: Sequence, prefixes: Iterable[str]) -> Optional[int]:
    """Nanoseconds inside the spans named with one of ``prefixes``, each
    counted once: a matching span inside another matching span adds
    nothing. None where no span matches."""
    prefixes = tuple(prefixes)
    hits = _closed(spans, prefixes)
    total = 0
    for i in hits:
        parent = spans[i].parent
        while parent is not None and not spans[parent].name.startswith(prefixes):
            parent = spans[parent].parent
        if parent is None:
            total += spans[i].end_ns - spans[i].start_ns
    return total if hits else None


def self_ns(spans: Sequence, prefixes: Iterable[str]) -> Optional[int]:
    """Self nanoseconds of the spans named with one of ``prefixes``: each
    one's length less its direct children's (any name). None where no span
    matches."""
    hits = _closed(spans, prefixes)
    if not hits:
        return None
    children: Dict[int, int] = {}
    for s in spans:
        if s.parent is not None and s.end_ns is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    return sum(spans[i].end_ns - spans[i].start_ns - children.get(i, 0) for i in hits)


def moved(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """Each counter's change from ``before`` to ``after``; counters that did
    not move are left out."""
    changes = {k: v - before.get(k, 0) for k, v in sorted(after.items())}
    return {k: d for k, d in changes.items() if d}


def per_step(before: Dict[str, int], after: Dict[str, int], steps: int) -> Dict[str, float]:
    """Each counter's change over ``steps`` steps, a step; counters that did
    not move are left out."""
    return {k: d / steps for k, d in moved(before, after).items()}


class PortProfile(profile.Profile):
    """A ``harness.profile.Profile`` with the port's spans (name, thread,
    start µs, end µs) and each launch's thread (by correlation id)."""

    def __init__(self, base: profile.Profile, port_spans, launch_threads: Dict[int, object]):
        super().__init__(base.ops, base.spans, base.launches, base.op_corr, base.steps)
        self.port_spans = sorted(port_spans, key=lambda s: s[2])
        self.launch_threads = launch_threads

    def _port_span_at(self, t: float, thread) -> Optional[str]:
        """The innermost port span open on ``thread`` at ``t``, or None."""
        label = None
        for name, tid, s, e in self.port_spans:
            if s > t:
                break
            if tid == thread and t <= e:
                label = name
        return label

    def idle_gaps_by_span(self, top: int = profile.TOP):
        """The longest idle stretches of the device, each labelled with the
        innermost port span open on the launching thread when the operation
        that ended the stretch was launched (matched by correlation id), or
        where none was open, with the harness span, as ``idle_gaps``."""
        starts = {}
        for (_, s, _), corr in zip(self.ops, self.op_corr):
            starts.setdefault(s, corr)
        intervals = self._busy_intervals()
        gaps = sorted(((nxt[0] - prev[1], starts.get(nxt[0]), nxt[0])
                       for prev, nxt in zip(intervals, intervals[1:])), key=lambda g: -g[0])
        labelled = []
        for length, corr, end in gaps[:top]:
            t = self.launches.get(corr, end) if corr is not None else end
            label = (self._port_span_at(t, self.launch_threads.get(corr))
                     if corr in self.launches else None)
            labelled.append([label or self._span_at(t), length / 1e6])
        return labelled


def read_chrome_trace(path: str, steps: int) -> PortProfile:
    """``harness.profile.read_chrome_trace``, with the port's annotations
    and the launches' threads."""
    base = profile.read_chrome_trace(path, steps)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    port_spans, launch_threads = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_threads[args["correlation"]] = e.get("tid")
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(PORT_PREFIX):
            port_spans.append((e["name"], e.get("tid"), float(e["ts"]),
                               float(e["ts"]) + float(e.get("dur", 0.0))))
    return PortProfile(base, port_spans, launch_threads)


def profile_steps(step, steps: int, synchronize) -> PortProfile:
    """``harness.profile.profile_steps``, read by ``read_chrome_trace``
    above. The port's spans reach the trace where its tracer is on."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    synchronize()
    with torch_profile(activities=activities) as prof:
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
