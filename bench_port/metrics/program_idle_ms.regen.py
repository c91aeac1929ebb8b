"""Device idle ms a regen in the program pass while a program span was
open on the thread that drives the cell: the program's own host work that
leaves the card idle (the rest of the idle is the caller's)."""

from bench_port.spans import idle_ms


def read(ctx):
    return idle_ms(ctx)
