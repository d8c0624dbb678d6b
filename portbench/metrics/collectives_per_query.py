"""collectives_per_query: the program's ``repro_collectives_total`` counter
(collectives issued by rank 0) over the queries of the pass with the
program's trace buffer on (``portbench/rank_spans.py``, pass A), per
query."""
from portbench import rank_spans


def read(run):
    res = rank_spans.reading(run)
    return None if res is None else res.collectives
