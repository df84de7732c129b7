"""kernels: the hand-written kernels' device ms as a share of a replay's
device ms (``step.device_ms``) over the profiled pass."""

from cmbench import trace


def read(run):
    if not run.get("profile"):
        return None
    ms, n = trace.hand_ms(run["profile"])
    step = trace.step_device_ms(run["profile"])
    if not n or not step:
        return None
    return 100.0 * ms / n / step
