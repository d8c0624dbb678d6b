"""merge_ms: rank 0's device ms per query of the operations launched inside
the sharded path's ``groupby.merge`` span (``repro_psum`` of the table, the
row count's all-reduce, MIN/MAX where asked), NCCL's wait for the slowest
card included, from the profiled pass after the window
(``portbench/rank_spans.py``, pass B)."""
from portbench import rank_spans


def read(run):
    return rank_spans.device_ms(run, rank_spans.MERGE)
