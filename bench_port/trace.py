"""The traced sub-window and its reduction: kernel time by name, the
device's busy time, the idle gaps and what the host was doing in them,
and the device time of a train step.

The profiler records the card's activity alone (CUDA): recording every
host operation as well costs the host enough to make a step of many small
launches wait on the host, so that the trace would measure the profiler.
The traced window runs from the first device operation's start to the
last one's end; a step's device time is read from CUDA events that the
driver records on the stream at each step's end (``step_marks``).
"""

from __future__ import annotations

import numpy as np


def traced(driver) -> dict:
    """Run ``driver.traced()`` under ``torch.profiler`` (device activity
    only) and reduce the trace (``summarize``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        units = driver.traced()
        torch.cuda.synchronize()
    out = summarize(list(prof.events()))
    out["units"] = units
    marks = getattr(driver, "step_marks", None) or []
    out["steps"] = step_times([a.elapsed_time(b) / 1e3
                               for a, b in zip(marks, marks[1:])])
    return out


def _on_device(e) -> bool:
    return (str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False))


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(evs) -> dict:
    """Reduce the profiler's events (times in microseconds) to seconds:
    ``window_s`` (the first device operation's start to the last one's
    end), ``busy_s`` (the union of device operations), ``kernel_s`` by
    name, the ten device operations that took most time and the ten
    longest idle gaps, each by the innermost CUDA runtime call under it
    (a gap with none under it is the host's own work between calls)."""
    dev = [e for e in evs if _on_device(e)]
    if not dev:
        return dict(window_s=None, busy_s=None, kernel_s={}, device_ops=[],
                    idle_gaps=[])
    host = [e for e in evs if not str(e.device_type).endswith("CUDA")]
    busy = _merge((e.time_range.start, e.time_range.end) for e in dev)
    w0, w1 = busy[0][0], busy[-1][1]
    kernel_s = {}
    for e in dev:
        dur = (e.time_range.end - e.time_range.start) / 1e6
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + dur
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:10]
    labelled = []
    for length, start in gaps:
        mid = start + length / 2
        under = [e for e in host
                 if e.time_range.start <= mid <= e.time_range.end]
        name = (min(under, key=lambda e: e.time_range.end
                    - e.time_range.start).name if under
                else "host outside CUDA calls")
        labelled.append([name, length / 1e6])
    return dict(window_s=(w1 - w0) / 1e6,
                busy_s=sum(b - a for a, b in busy) / 1e6,
                kernel_s=kernel_s,
                device_ops=[[k, v] for k, v in top], idle_gaps=labelled)


def step_times(periods_s) -> dict:
    """The median device time of a train step, in seconds, from the time
    between consecutive step ends on the stream (as the repository's chip
    smoke reads a step, ``trace_steps``: end to end); ``{}`` where fewer
    than two periods were read."""
    if len(periods_s) < 2:
        return {}
    return dict(step_s=float(np.median(periods_s)))
