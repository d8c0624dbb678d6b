"""lattice_ms: rank 0's device ms per query of the operations launched
inside the sharded path's ``groupby.lattice`` span (the all-reduce MAX that
agrees the lattice before extraction), NCCL's wait for the slowest card
included, from the profiled pass after the window
(``portbench/rank_spans.py``, pass B)."""
from portbench import rank_spans


def read(run):
    return rank_spans.device_ms(run, rank_spans.LATTICE)
