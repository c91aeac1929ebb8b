"""The whole regen's share of the card's peaks: the law's work of one
regen (every kernel's, counts/law.py) at the int32 and HBM peaks
(counts/peaks.py), over the device's busy time a regen in the traced
sub-window, in %.  The busy time holds every device operation a regen
runs and none of the host's time, so the share bounds each kernel's
roofline share from above, whichever kernels a later design runs."""

from bench_port.counts import peaks


def read(ctx):
    work, t = ctx["counts"].get("regen"), ctx["trace"]
    if work is None or not t.get("units") or not t.get("busy_s"):
        return None
    bound = peaks.bound_s(work[0], work[1], ctx["sms"], ctx["max_sm_mhz"])
    return 100.0 * bound / (t["busy_s"] / t["units"])
