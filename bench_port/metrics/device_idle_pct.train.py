"""Share of the traced sub-window of train steps with no device operation."""

from bench_port.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
