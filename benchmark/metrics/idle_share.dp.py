"""Share of the profiled sub-window in which no kernel, copy or set ran on
the card, averaged over the data-parallel ranks' cards."""
from benchmark.readers import idle_share


def read(trace):
    return idle_share(trace)
