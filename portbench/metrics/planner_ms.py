"""planner_ms: host ms per query inside the program's ``groupby.plan`` span
(``plan_groupby`` and the prescan's statistics), by the program's own
span records with its trace buffer on and no profiler
(``portbench/spans.py``, pass A)."""
from portbench import spans


def read(run):
    return spans.host_ms(run, "groupby.plan")
