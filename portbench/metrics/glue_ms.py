"""glue_ms: device ms per query in every other device operation (torch's
kernels, memcpy and memset) over the traced stretch: the operator's eager
glue (column build, prescan, planner reads, finalize)."""


def read(run):
    if run.stretch is None or not run.stretch.device_ops:
        return None
    glue = run.stretch.device_s() - run.hand_kernel_s()
    return glue / run.stretch.queries * 1e3
