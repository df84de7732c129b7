"""pipeline: host ms of a batch's own work in the gpu-full pipeline:
``encode`` + ``full_state`` + ``full_writeback`` + ``full_replay`` (the
pipeline's GLOBAL_TIMER phases over the window) per batch."""

PHASES = ("encode", "full_state", "full_writeback", "full_replay")


def read(run):
    tot = run["timer"]["totals"]
    if not run["batches"] or "encode" not in tot:
        return None
    return 1e3 * sum(tot.get(p, 0.0) for p in PHASES) / run["batches"]
