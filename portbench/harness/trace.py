"""Reading a ``torch.profiler`` trace of the measured window: the device's
busy time as the union of its operations' intervals (overlapping kernels
count once), device time by operation name, and the idle gaps by what the
host was doing. Events are read straight from the profiler's Kineto
results, which keeps a window of a million events to seconds."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW_MARK = 'portbench.window'
# a gap shorter than this is launch spacing, not the host holding the card
GAP_MIN_S = 20e-6
TOP = 10


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _span(ev) -> Tuple[float, float]:
    if hasattr(ev, 'start_ns'):
        s = ev.start_ns() * 1e-9
        return s, s + ev.duration_ns() * 1e-9
    s = ev.start_us() * 1e-6
    return s, s + ev.duration_us() * 1e-6


def _is_device(ev) -> bool:
    return 'CPU' not in str(ev.device_type())


def short_name(name: str) -> str:
    """A kernel's name without its parameter list."""
    name = re.sub(r'^void ', '', name)
    depth, out = 0, []
    for ch in name:
        if ch == '(' and depth == 0 and out:
            break
        depth += ch == '<'
        depth -= ch == '>'
        out.append(ch)
    return ''.join(out)[:120]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def read(prof) -> Dict:
    """{'window_s', 'busy_s', 'kernel_s' {name: s}, 'device_ops',
    'idle_gaps'} over the span of the ``WINDOW_MARK`` record."""
    events = prof.profiler.kineto_results.events()
    w0 = w1 = None
    dev: List[Tuple[float, float, str]] = []
    cpu: List[Tuple[float, float, str]] = []
    for ev in events:
        s, e = _span(ev)
        name = ev.name()
        if _is_device(ev):
            # the window's own mark also shows on the device's timeline
            if name != WINDOW_MARK:
                dev.append((s, e, name))
        elif name == WINDOW_MARK:
            w0, w1 = s, e
        else:
            cpu.append((s, e, name))
    if w0 is None:
        raise RuntimeError('the trace has no window mark')
    kernel_s: Dict[str, float] = defaultdict(float)
    clipped = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            kernel_s[short_name(name)] += e - s
    busy = union(clipped)
    busy_s = sum(e - s for s, e in busy)
    # idle gaps, each named by the innermost host event over its middle
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a < GAP_MIN_S:
            continue
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid)
        owner = 'host outside any op'
        for s, e, name in reversed(cpu[max(0, k - 64):k]):
            if e >= mid:
                owner = name
                break
        gaps[owner] += b - a
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {'window_s': w1 - w0, 'busy_s': busy_s, 'kernel_s': dict(kernel_s),
            'device_ops': [[n, s] for n, s in top],
            'idle_gaps': [[n, s] for n, s in top_gaps]}
