"""device_idle: the share of the traced stretch (first query's start to
the last query's end) in which no operation ran on the card, in %."""


def read(run):
    if run.stretch is None or not run.stretch.device_ops:
        return None
    return 100.0 * (1.0 - run.stretch.busy_s() / run.stretch.seconds)
