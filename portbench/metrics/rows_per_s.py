"""rows_per_s: rows aggregated by all queries completed in the window, over
the window's seconds (host clock; each query ends in a synchronize)."""


def read(run):
    return run.rows * len(run.latencies_s) / run.window_s
