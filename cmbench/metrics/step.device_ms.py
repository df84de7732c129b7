"""step: device ms of one replay of the fused step's CUDA graph, the
union of its operations' intervals, averaged over the replays of the
profiled pass."""

from cmbench import trace


def read(run):
    if not run.get("profile"):
        return None
    return trace.step_device_ms(run["profile"])
