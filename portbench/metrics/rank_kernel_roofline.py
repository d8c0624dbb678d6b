"""rank_kernel_roofline: ``kernel_roofline`` of one rank -- the least time
of the query over rank 0's rows (``Run.rank_rows``; ``work.py``) over rank
0's device time per query in the program's hand-written kernels, in %."""
from portbench import work


def read(run):
    peak = work.peaks(run.device_kind)
    if run.stretch is None or peak is None or not run.rank_rows:
        return None
    s = run.hand_kernel_s() / run.stretch.queries
    if s <= 0:
        return None
    least, _ = work.least_seconds(run.config, run.rank_rows, run.groups,
                                  peak)
    return 100.0 * least / s
