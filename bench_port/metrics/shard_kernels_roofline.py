"""The §7.2 expansion's share of its bound (counts/law.py): the device
time a regen of every shard kernel (the row records and the expansion, or
the copy of the sequential mode) against the law's work."""

from bench_port.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "shard_kernels", "shard_row_keys_kernel",
                        "shard_expand_kernel", "shard_copy_kernel")
