"""The gradient all-reduce's share of card 0's link peak, in %: the bytes a
card moves a direction for one all-reduce of the flat buffer
(``counts/link.py``: 2(n-1)/n of it on NCCL's ring, its bus bandwidth) over
rank 0's NCCL time a step, against the links' peak a direction that
``nvidia-smi`` reads.  Nothing where NCCL's kernels name NVLink SHARP
(``NVLS``): it moves other bytes, which no count here models, and a ring's
count over its time could pass the peak."""

from bench_port.counts import link
from bench_port.readers import nccl_kernels


def read(ctx):
    t, c = ctx["trace"], ctx["counts"]
    found = nccl_kernels(t)
    if not found or not t.get("units") or "allreduce_bytes" not in c:
        return None
    peak = link.link_peak_bytes_per_s(0)
    if not peak:
        return None
    if any("NVLS" in k for k in found):
        return None
    moved = link.link_bytes(c["allreduce_bytes"], c["world"])
    return 100.0 * moved / (sum(found.values()) / t["units"]) / peak
