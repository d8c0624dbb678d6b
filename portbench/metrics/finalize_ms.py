"""finalize_ms: device ms per query of the operations launched inside the
program's ``groupby.finalize`` span (the table's conversion to floats and
the aggregates' formulas), from the profiled pass of the program's queries
after the window (``portbench/spans.py``, pass B)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "groupby.finalize")
