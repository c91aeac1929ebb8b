"""Model FLOPs of the window's steps (counts/model.py; a data-parallel
step's over all its ranks) over its wall, against the dense bf16 peak
(counts/peaks.py) of the cell's cards, in %."""

from bench_port.counts import peaks


def read(ctx):
    h, flops = ctx["host"], ctx["counts"].get("train_step_flops")
    if not h.get("steps") or flops is None:
        return None
    rate = flops * h["steps"] / h["wall_s"]
    return 100.0 * rate / (peaks.BF16_DENSE_FLOPS
                           * ctx["cell"]["entry"]["chips"])
