"""step: device operations (kernels, copies, memsets) of one replay of the
fused step's CUDA graph, the median over the replays of the profiled
pass."""

import statistics

from cmbench import trace


def read(run):
    if not run.get("profile"):
        return None
    reps = trace.replays(run["profile"])
    if not reps:
        return None
    return float(statistics.median(len(r) for r in reps))
