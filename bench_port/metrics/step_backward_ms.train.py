"""The median device ms of ``step.backward`` a step in the program pass
(the events its span recorded on the step's stream)."""

from bench_port.spans import median_of


def read(ctx):
    return median_of(ctx, "device_ms", "step.backward")
