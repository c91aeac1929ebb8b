"""The host ms a step of ``loader.wait`` (the consumer's take from the
prefetch queue) in the program pass: the loader's own timing of the
wait that loader_wait_ms.train times from outside."""

from bench_port.spans import program


def read(ctx):
    p = program(ctx)
    waits = p and p["host_ms"].get("loader.wait")
    return None if not waits or not p["units"] else sum(waits) / p["units"]
