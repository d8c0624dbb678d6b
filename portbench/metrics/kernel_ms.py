"""kernel_ms: device ms per query in the kernels that the program's CUDA
sources define (``kernels/*/csrc/*.cu``), over the traced stretch."""


def read(run):
    if run.stretch is None:
        return None
    s = run.hand_kernel_s()
    return s / run.stretch.queries * 1e3 if s > 0 else None
