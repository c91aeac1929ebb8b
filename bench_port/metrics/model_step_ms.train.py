"""Median device time of a train step in the traced sub-window: the time
between consecutive step ends on the stream (trace.step_times)."""


def read(ctx):
    steps = ctx["trace"].get("steps") or {}
    return None if "step_s" not in steps else 1e3 * steps["step_s"]
