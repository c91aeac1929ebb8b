"""The median host ms of a regen's outermost span in the program pass
(``psds_shard_regen`` in shard mode, else ``psds_epoch_regen``): the
inside counterpart of entry_host_ms.regen, without the caller's loop."""

from bench_port.spans import REGEN_SPANS, median_of


def read(ctx):
    return median_of(ctx, "host_ms", *REGEN_SPANS)
