"""Host time a regen beyond the device's: the untraced window's host wall
a regen minus the device busy time a regen in the traced sub-window."""


def read(ctx):
    t, host = ctx["trace"], ctx["host"]
    if not t.get("units") or t.get("busy_s") is None:
        return None
    return host["metrics"]["regen_ms"] - 1e3 * t["busy_s"] / t["units"]
