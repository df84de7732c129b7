"""pipeline: the share of reads that the fused step defers to the host
replay (``full_stats`` over the window)."""


def read(run):
    fs = run["full_stats"]
    if not fs.get("reads"):
        return None
    return 100.0 * fs["deferred"] / fs["reads"]
