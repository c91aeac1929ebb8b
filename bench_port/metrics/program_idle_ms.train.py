"""Device idle ms a train step in the program pass while a program span
(the step's, the loader's wait) was open on the thread that drives the
cell: the program's own host work that leaves the card idle."""

from bench_port.spans import idle_ms


def read(ctx):
    return idle_ms(ctx)
