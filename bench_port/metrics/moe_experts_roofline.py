"""The held experts' grouped products' share of the dense bf16 peak, in %:
the FLOPs of their (token, slot) pairs in the traced steps (the MoE
layers' counter, ``kinds/deepseek_v2.expert_pair_flops`` a pair: gate, up
and down, forward and backward, and the forward's recomputation in the
backward where the model recomputes) over the device time of the grouped
GEMM's kernels, which only those products launch (``GROUPED``)."""

from bench_port.counts import peaks
from bench_port.readers import kernel_s

#: the grouped GEMM's kernels by name: CUTLASS's grouped problem shape
GROUPED = ("GroupProblemShape",)


def read(ctx):
    t, flops = ctx["trace"], ctx["counts"].get("moe_experts_flops")
    k = kernel_s(t, *GROUPED)
    if k is None or flops is None or not t.get("units"):
        return None
    return 100.0 * flops / peaks.BF16_DENSE_FLOPS / (k / t["units"])
