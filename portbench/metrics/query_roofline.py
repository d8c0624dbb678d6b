"""query_roofline: the whole operator's share of the card's peak over the
traced stretch -- queries x the least time of one query (``work.py``) over
the stretch's seconds, in %."""
from portbench import work


def read(run):
    peak = work.peaks(run.device_kind)
    if run.stretch is None or peak is None:
        return None
    least, _ = work.least_seconds(run.config, run.rows, run.groups, peak)
    return 100.0 * run.stretch.queries * least / run.stretch.seconds
