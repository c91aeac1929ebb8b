"""The host's wait inside the loader's next() a step, over the window."""


def read(ctx):
    h = ctx["host"]
    return None if not h.get("steps") else 1e3 * h["wait_s"] / h["steps"]
