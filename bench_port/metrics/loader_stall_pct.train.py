"""BASELINE.json's DataLoader stall %: wait over wait + compute, as the
stall probe (stall.py) reads them over the window."""


def read(ctx):
    h = ctx["host"]
    total = h.get("wait_s", 0.0) + h.get("compute_s", 0.0)
    return None if total <= 0 else 100.0 * h["wait_s"] / total
