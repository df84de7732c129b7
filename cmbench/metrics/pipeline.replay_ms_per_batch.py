"""pipeline (host): ms of the host replay of the reads that the fused step
defers, per batch: GLOBAL_TIMER ``full_replay`` over the window (its host
lookup, gather, chain and finish).  0.0 where no read was deferred; None
where the window mapped no batch or no read."""


def read(run):
    if not run["batches"] or not run["full_stats"].get("reads"):
        return None
    return 1e3 * run["timer"]["totals"].get("full_replay", 0.0) \
        / run["batches"]
