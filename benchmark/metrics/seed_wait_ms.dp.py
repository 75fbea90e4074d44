"""Rank 0's host ms a step of the program's span ``sgc.step.rank_seed``
(``parallel.rank_generator``: the host waits there for its dropout draw
from the card, ``.item()``), read from rank 0's recorder over the profiled
sub-window (``program_trace``)."""
from benchmark.program_trace import span_ms


def read(trace):
    return span_ms(trace, "sgc.step", "sgc.step.rank_seed", "host_ms")
