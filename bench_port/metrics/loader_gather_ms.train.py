"""The median host ms of ``loader.gather``, a batch's gather into pinned
memory on the loader's prefetch thread, in the program pass."""

from bench_port.spans import median_of


def read(ctx):
    return median_of(ctx, "host_ms", "loader.gather")
