"""The gradient all-reduce's bytes and the link's peak, for
``allreduce_roofline``: the bytes each card moves a direction for one
all-reduce on NCCL's ring, and card 0's link peak a direction, read from
``nvidia-smi`` at run time."""

from __future__ import annotations

import re
import subprocess

#: bytes a lane moves a second, a direction, by PCIe generation (after
#: 8b/10b to generation 2, 128b/130b from generation 3)
PCIE_LANE_BYTES_PER_S = {1: 0.25e9, 2: 0.5e9, 3: 8e9 / 8 * 128 / 130,
                         4: 16e9 / 8 * 128 / 130, 5: 32e9 / 8 * 128 / 130,
                         6: 64e9 / 8 * 128 / 130}


def allreduce_bytes(params: int) -> int:
    """The port's flat float32 buffer: every gradient and the loss."""
    return 4 * (params + 1)


def link_bytes(nbytes: float, world: int) -> float:
    """The bytes a card sends (and receives) for one all-reduce of
    ``nbytes`` on a ring: its reduce-scatter and all-gather move 2(n-1)/n
    of the buffer (NCCL's bus bandwidth)."""
    return 2.0 * (world - 1) / world * nbytes


def nvlink_bytes_per_s(text: str):
    """The sum of the link speeds that ``nvidia-smi nvlink -s`` gives
    (GB/s a direction, each link), or None where it lists none."""
    speeds = [float(x) for x in re.findall(r"Link \d+:\s*([\d.]+)\s*GB/s",
                                           text)]
    return sum(speeds) * 1e9 if speeds else None


def pcie_bytes_per_s(gen: int, width: int) -> float:
    return PCIE_LANE_BYTES_PER_S[int(gen)] * int(width)


def _smi(*args) -> str:
    res = subprocess.run(["nvidia-smi", *args], capture_output=True,
                         text=True, timeout=60)
    return res.stdout if res.returncode == 0 else ""


def link_peak_bytes_per_s(card: int = 0):
    """Card ``card``'s link peak a direction: its NVLinks' speeds summed,
    or where it has none its PCIe generation x width; None where
    ``nvidia-smi`` reads neither."""
    peak = nvlink_bytes_per_s(_smi("nvlink", "-s", "-i", str(card)))
    if peak:
        return peak
    row = _smi("-i", str(card), "--query-gpu=pcie.link.gen.max,"
               "pcie.link.width.max", "--format=csv,noheader,nounits")
    try:
        gen, width = (int(x) for x in row.strip().split(","))
    except ValueError:
        return None
    return pcie_bytes_per_s(gen, width)
