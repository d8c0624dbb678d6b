"""prescan_ms: device ms per query of the operations launched inside the
program's ``groupby.prescan`` span (``required_e1`` and the level window's
prescan, ``_resolve_levels``), from the profiled pass of the program's
queries after the window (``portbench/spans.py``, pass B)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "groupby.prescan")
