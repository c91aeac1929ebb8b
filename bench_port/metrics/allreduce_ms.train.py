"""Rank 0's device time a step in NCCL's kernels (the gradient all-reduce,
the step's one collective) over the traced sub-window's steps, in ms."""

from bench_port.readers import nccl_kernels


def read(ctx):
    t = ctx["trace"]
    found = nccl_kernels(t)
    if not found or not t.get("units"):
        return None
    return 1e3 * sum(found.values()) / t["units"]
