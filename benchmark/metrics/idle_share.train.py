"""Share of the profiled sub-window in which no kernel, copy or set ran on
the card."""
from benchmark.readers import idle_share


def read(trace):
    return idle_share(trace)
