"""pipeline (host): the share of reads that the fused step defers to the
host replay for an overflow of its X-drop DP pool (``XD_POOL`` rows; the
cause ``xdpool`` of ``full_stats["causes"]`` over ``full_stats["reads"]``,
over the window).  A read may carry several causes."""

CAUSE = "xdpool"


def read(run):
    fs = run["full_stats"]
    if not fs.get("reads"):
        return None
    return 100.0 * fs.get("causes", {}).get(CAUSE, 0) / fs["reads"]
