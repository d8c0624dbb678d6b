"""kernel_roofline: the least time of the query on the card's published
peaks (``work.py``: its input columns and group ids read once, its results
written once) over the device time per query of the program's hand-written
kernels, in %."""
from portbench import work


def read(run):
    peak = work.peaks(run.device_kind)
    if run.stretch is None or peak is None:
        return None
    s = run.hand_kernel_s() / run.stretch.queries
    if s <= 0:
        return None
    least, _ = work.least_seconds(run.config, run.rows, run.groups, peak)
    return 100.0 * least / s
