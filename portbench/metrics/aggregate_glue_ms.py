"""aggregate_glue_ms: device ms per query of the operations launched inside
the program's ``groupby.aggregate`` span (``segment_table`` around the
kernel's operator), less the kernels pinned in ``hand_kernels/*.json``,
from the profiled pass of the program's queries after the window
(``portbench/spans.py``, pass B)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "groupby.aggregate")
