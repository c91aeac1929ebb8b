"""mixture_fused's share of the §8 law's bound (counts/mixture.py), by its
device time a regen in the trace."""

from bench_port.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "mixture_fused", "mixture_fused_kernel")
