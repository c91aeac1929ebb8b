"""index_amortized's share of the law's bound (counts/law.py), by its
device time a regen in the trace."""

from bench_port.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "index_amortized", "index_amortized_kernel")
