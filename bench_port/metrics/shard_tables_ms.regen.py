"""The median host ms of ``shard.tables`` (the shard size tables' lookup,
a pass over every size) in the program pass."""

from bench_port.spans import median_of


def read(ctx):
    return median_of(ctx, "host_ms", "shard.tables")
