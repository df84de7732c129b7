"""device: the share of the profiled pass in which the card ran no
operation (kernel, copy or memset)."""

from cmbench import trace


def read(run):
    prof = run.get("profile")
    if not prof or not prof["device"]:
        return None
    return 100.0 * (1.0 - trace.window_busy_s(prof) / trace.window_s(prof))
