"""launches_per_query: CUDA kernel launches per query over the traced
stretch (kernels only; memcpy and memset are not counted)."""


def read(run):
    if run.stretch is None or not run.stretch.kernels():
        return None
    return len(run.stretch.kernels()) / run.stretch.queries
