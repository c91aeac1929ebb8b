"""The median device ms between the events a regen's outermost span
recorded at its start and end, in the program pass; less the kernels'
time, the device idle that the host's routing leaves inside a regen."""

from bench_port.spans import REGEN_SPANS, median_of


def read(ctx):
    return median_of(ctx, "device_ms", *REGEN_SPANS)
