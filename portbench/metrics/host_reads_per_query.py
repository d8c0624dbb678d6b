"""host_reads_per_query: the program's ``repro_host_reads_total`` counter
(reads of a device tensor's value by the host, each a wait for the
device) over the queries of ``portbench/spans.py``'s pass A, per query."""
from portbench import spans


def read(run):
    res = spans.reading(run)
    return None if res is None else res.host_reads
