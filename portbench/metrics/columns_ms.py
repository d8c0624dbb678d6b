"""columns_ms: device ms per query of the operations launched inside the
program's ``groupby.columns`` span (the column build: ``_as_matrix``, the
keys' conversion, ``_build_columns``), from the profiled pass of the
program's queries after the window (``portbench/spans.py``, pass B)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "groupby.columns")
