"""The share of the consumer's requests in the program pass that found a
batch ready in the loader's queue (its counters ``batches_ready`` over
``batches_served``), in %."""

from bench_port.spans import program


def read(ctx):
    p = program(ctx)
    served = p and p["counters"].get("batches_served")
    return (None if not served
            else 100.0 * p["counters"].get("batches_ready", 0) / served)
