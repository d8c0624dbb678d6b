"""setup_s: process start to the first timed query (host clock): torch's
import, the CUDA context, loading (or at a checkout's first run building)
the kernels, drawing the table on the card, and two warm-up queries."""


def read(run):
    return run.setup_s
