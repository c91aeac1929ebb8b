"""The card's peaks, from NVIDIA's H100 SXM data sheet (dense rates, at the
full 700 W power limit); the SM count and clock are read from the card."""

from __future__ import annotations

BF16_DENSE_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
#: a Hopper SM issues 4 partitions x 16 INT32 lanes a clock
INT32_OPS_PER_CLK_PER_SM = 64


def int32_ops_per_s(sms: int, max_sm_mhz: float) -> float:
    return INT32_OPS_PER_CLK_PER_SM * sms * max_sm_mhz * 1e6


def bound_s(ops: float, nbytes: float, sms: int, max_sm_mhz: float) -> float:
    """The least time the card could take: the larger of the operations
    over the int32 issue rate and the bytes over the HBM rate."""
    return max(ops / int32_ops_per_s(sms, max_sm_mhz),
               nbytes / HBM_BYTES_PER_S)
