"""rank_query_roofline: ``query_roofline`` of one rank -- the traced
stretch's queries x the least time of one query over rank 0's rows
(``Run.rank_rows``; ``work.py``) over the stretch's seconds, in %.  Over
every rank's rows (``Run.rows``) the share would read ``world`` times too
high: each card reads only its own."""
from portbench import work


def read(run):
    peak = work.peaks(run.device_kind)
    if run.stretch is None or peak is None or not run.rank_rows:
        return None
    least, _ = work.least_seconds(run.config, run.rank_rows, run.groups,
                                  peak)
    return 100.0 * run.stretch.queries * least / run.stretch.seconds
