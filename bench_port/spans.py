"""The program's own spans over the device trace: a second traced pass with
the port's tracer on, and its reduction.

    python3 bench_port/spans.py --workload <cell> --seed <n> --seconds <s>

runs one cell as ``run.py --trace 1`` does, with this pass after the
first traced pass (``program_pass``), and prints the result line with the
per-layer metrics of ``program_metrics.json`` beside the cell's own, the
pass's ten longest idle gaps named by program span
(``breakdown.program_gaps``) and what tracing cost a unit.

The first traced pass records device activity alone and the program's
tracer stays off, so every number read from it is what it was.  The
program pass runs ``driver.traced()`` once more under the same profiler
with the tracer on: a regen cell repeats the first pass's epochs, a train
cell takes its next steps (before the steady step, which starts from the
program's own state).  A span's entry carries ``start_ns`` on the
profiler's clock (Unix-epoch nanoseconds, the clock of
``kineto_results.trace_start_ns()``), so the pass lays the spans over the
device's busy intervals: which span was open in each idle gap, and how
much device idle falls inside the program's spans on the thread that
drives the cell (the program's host work) rather than outside them (the
caller's).  A program without spans, or without ``start_ns``, leaves
those readings out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from bench_port import harness, trace  # noqa: E402

#: the ring's size for the pass: 2,000 regens of one span, 500 of five,
#: or the train steps' seven, with room
CAPACITY = 1 << 16
#: the metrics read from the program pass, as BENCHMARK.json entries
METRICS_FILE = os.path.join(harness.HERE, "program_metrics.json")
#: the outermost span of a regen, by path: shard mode, else the index
REGEN_SPANS = ("psds_shard_regen", "psds_epoch_regen")
OUTSIDE = "outside program spans"


def program_pass(driver, activities=None) -> dict:
    """``driver.traced()`` under ``torch.profiler`` (``activities``,
    default the card's alone) with the port's tracer on: the reduced pass
    (``reduce``).  The tracer is reset afterwards."""
    from torch.profiler import ProfilerActivity, profile

    from partiallyshuffledistributedsampler_tpu_torch import telemetry

    registry = getattr(getattr(driver, "loader", None), "metrics", None)
    before = counters(registry)
    driver.sync()
    telemetry.configure(enabled=True, capacity=CAPACITY)
    try:
        with profile(activities=activities
                     or [ProfilerActivity.CUDA]) as prof:
            units = driver.traced()
            driver.sync()
        entries = telemetry.snapshot()
    finally:
        telemetry.reset()
    after = counters(registry)
    return reduce(list(prof.events()), entries,
                  prof.profiler.kineto_results.trace_start_ns(), units,
                  threading.current_thread().name,
                  {k: v - before.get(k, 0) for k, v in after.items()})


def counters(registry) -> dict:
    return {} if registry is None else dict(registry.snapshot()["counters"])


def _innermost(spans, at):
    """The span open at ``at`` that started last (the innermost)."""
    under = [s for s in spans if s[0] <= at <= s[1]]
    return max(under, key=lambda s: s[0]) if under else None


def _overlap(intervals, covered) -> float:
    """Length of ``intervals`` (sorted, disjoint) inside ``covered``
    (sorted, disjoint)."""
    total, j = 0.0, 0
    for a, b in intervals:
        while j < len(covered) and covered[j][1] <= a:
            j += 1
        k = j
        while k < len(covered) and covered[k][0] < b:
            total += min(b, covered[k][1]) - max(a, covered[k][0])
            k += 1
    return total


def reduce(evs, entries, start_ns: int, units: int, thread: str,
           counted: dict) -> dict:
    """The pass's reduction: its device window and busy time
    (``trace.summarize``), each span name's host ms and device ms, the
    device idle inside the driving thread's spans, the ten longest idle
    gaps by the innermost span open at their midpoint, the program's
    counters over the pass, and how many index regen spans enclose a
    kernel launch on the shared clock."""
    base = trace.summarize(evs)
    spans = [e for e in entries if e.get("kind") == "span"
             and e.get("ms") is not None]
    host_ms, device_ms = {}, {}
    for e in spans:
        host_ms.setdefault(e["name"], []).append(e["ms"])
        if isinstance(e.get("device_ms"), float):
            device_ms.setdefault(e["name"], []).append(e["device_ms"])
    # µs from the trace's start, as the profiler's events (an int
    # difference first: a float of the epoch's ns is 0.25 µs coarse)
    placed = [((e["start_ns"] - start_ns) / 1e3,
               (e["start_ns"] - start_ns) / 1e3 + e["ms"] * 1e3, e["name"],
               e.get("thread")) for e in spans
              if e.get("start_ns") is not None]
    out = dict(units=units, window_s=base["window_s"],
               busy_s=base["busy_s"], host_ms=host_ms, device_ms=device_ms,
               counters=counted, idle_in_spans_s=None, gaps=[],
               launches_enclosed=None)
    if not placed:
        return out

    busy = trace._merge((e.time_range.start, e.time_range.end)
                        for e in evs if trace._on_device(e))
    idle = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    own = [s for s in placed if s[3] == thread]
    covered = trace._merge((a, b) for a, b, _, _ in own)
    out["idle_in_spans_s"] = _overlap(idle, covered) / 1e6
    named = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        hit = _innermost(own, mid)
        if hit is None:
            hit = _innermost(placed, mid)
            name = OUTSIDE if hit is None else f"{hit[2]} ({hit[3]})"
        else:
            name = hit[2]
        named.append([name, (b - a) / 1e6])
    out["gaps"] = named
    launches = [(e.time_range.start, e.time_range.end) for e in evs
                if "LaunchKernel" in e.name
                and not str(e.device_type).endswith("CUDA")]
    regens = [s for s in placed if s[2] == "psds_epoch_regen"]
    if launches and regens:
        out["launches_enclosed"] = [
            sum(any(s[0] <= a and b <= s[1] for a, b in launches)
                for s in regens), len(regens)]
    return out


def with_program_pass(first_pass):
    """``first_pass`` (``trace.traced``) followed by the program pass:
    the first pass's summary as it is, with the program pass under
    ``program``."""
    def traced(driver):
        out = first_pass(driver)
        out["program"] = program_pass(driver)
        return out

    return traced


# ------------------------------------------------------------- readers
def program(ctx):
    """The program pass of a run, or None where the run made none."""
    return (ctx.get("trace") or {}).get("program")


def median_of(ctx, kind: str, *names):
    """The median of the first of ``names`` that the pass has, of
    ``kind`` (``host_ms`` or ``device_ms``); None where it has none."""
    p = program(ctx)
    for name in names if p else ():
        values = p[kind].get(name)
        if values:
            return statistics.median(values)
    return None


def idle_ms(ctx):
    """Device idle ms a unit inside the driving thread's spans."""
    p = program(ctx)
    if not p or p["idle_in_spans_s"] is None or not p["units"]:
        return None
    return 1e3 * p["idle_in_spans_s"] / p["units"]


# --------------------------------------------------------------- the run
def load_metrics() -> list:
    with open(METRICS_FILE) as f:
        return json.load(f)


def measure(workload: str, seed: int, seconds: float) -> dict:
    """One traced run of ``workload`` by the harness, with the program
    pass after its first traced pass and the metrics of
    ``program_metrics.json`` read beside the cell's: the result line,
    with ``breakdown.program_gaps`` and ``program`` (the pass's units,
    counters, enclosed launches, each span's median host and device ms,
    and each pass's device window a unit).  ``trace.traced`` and
    ``harness.load_cell`` are wrapped for the run: the harness itself
    runs unchanged around them."""
    first_pass, load_cell = trace.traced, harness.load_cell
    both, seen = with_program_pass(first_pass), {}

    def traced(driver):
        seen["first"] = both(driver)
        return seen["first"]

    def cell_with_program_metrics(name):
        cell = load_cell(name)
        cell["per_layer"] = cell["per_layer"] + [
            m for m in load_metrics() if name in m["workloads"]]
        return cell

    trace.traced, harness.load_cell = traced, cell_with_program_metrics
    try:
        line, _checks = harness.measure(workload, seed, seconds, True)
    finally:
        trace.traced, harness.load_cell = first_pass, load_cell
    first, p = seen["first"], seen["first"]["program"]
    line["breakdown"]["program_gaps"] = p["gaps"]
    line["program"] = dict(
        units=p["units"], counters=p["counters"],
        launches_enclosed=p["launches_enclosed"],
        median_host_ms={k: statistics.median(v)
                        for k, v in p["host_ms"].items()},
        median_device_ms={k: statistics.median(v)
                          for k, v in p["device_ms"].items()},
        first_window_ms_a_unit=_ms_a_unit(first),
        spans_window_ms_a_unit=_ms_a_unit(p))
    return line


def _ms_a_unit(summary):
    """A traced pass's device window (first operation to last) a unit."""
    if not summary["window_s"] or not summary["units"]:
        return None
    return 1e3 * summary["window_s"] / summary["units"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    try:
        line = measure(args.workload, args.seed, args.seconds)
    except harness.BenchError as exc:
        print(f"bench_port: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
