"""kernels: the hand-written kernels' share of their roofline in a replay:
the sum of their bounds (``cmbench/work/``: bytes over HBM bandwidth or
int32 operations over the ALU peak, whichever is longer, each launch
counted on its own inputs over every batch of the profiled pass's library,
recorded in eager steps after the window) over their measured device ms
in the profiled pass's replays, a step's bound for each replay."""

from cmbench import trace


def read(run):
    work = run.get("work")
    if not run.get("profile") or not work or not work["steps"]:
        return None
    ms, n = trace.hand_ms(run["profile"])
    if not n or ms <= 0:
        return None
    return 100.0 * sum(work["bounds"].values()) / work["steps"] * n / ms
