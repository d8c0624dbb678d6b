"""repro_slowdown: the paper's metric -- the mean query time (host clock,
the window's queries outside the traced stretch, which the profiler slows)
over the device time of a float32 ``index_add_`` of the same summed columns
into the same groups (CUDA events, after the window)."""
import statistics

import torch

from portbench import devtrace, work


def read(run):
    if run.device.type != "cuda":
        return None
    outside = [t for i, t in enumerate(run.latencies_s)
               if i not in run.stretch_queries]
    if not outside:
        return None
    x = run.values[:, work.summed_columns(run.config)].contiguous()
    table = torch.zeros((run.groups, x.shape[1]), dtype=torch.float32,
                        device=run.device)
    ms = devtrace.cuda_ms(lambda: table.index_add_(0, run.keys, x),
                          reps=5, batch=5)
    return statistics.mean(outside) * 1e3 / ms
