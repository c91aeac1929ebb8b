"""Helpers the per-layer readers share: kernel time by name from the
trace, and a kernel's share of the law's bound."""

from __future__ import annotations

from bench_port.counts import peaks


def kernel_s(trace: dict, *names: str):
    """Total device seconds of the kernels whose name holds one of
    ``names``, or None where the trace has none."""
    hits = [s for k, s in trace["kernel_s"].items()
            if any(n in k for n in names)]
    return sum(hits) if hits else None


def roofline_pct(ctx: dict, count: str, *names: str):
    """The bound of one unit's counted work over the kernels' device time
    a unit, in %: None where the kernels or the count are missing."""
    t = ctx["trace"]
    k = kernel_s(t, *names)
    if k is None or count not in ctx["counts"] or not t.get("units"):
        return None
    ops, nbytes = ctx["counts"][count]
    bound = peaks.bound_s(ops, nbytes, ctx["sms"], ctx["max_sm_mhz"])
    return 100.0 * bound / (k / t["units"])


def idle_pct(ctx: dict):
    t = ctx["trace"]
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def nccl_kernels(trace: dict) -> dict:
    """``{name: device seconds}`` of NCCL's kernels in the trace: names that
    begin ``nccl`` (a ``void`` return type aside)."""
    return {k: s for k, s in trace["kernel_s"].items()
            if k.removeprefix("void ").startswith("nccl")}
