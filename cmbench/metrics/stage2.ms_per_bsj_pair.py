"""stage 2: host ms per back-splice pair of the harness's span around the
BSJ select and sort, ``ProcessCirc.run(device_ext=True)`` and the report,
over the window."""


def read(run):
    if "stage2" not in run["spans"] or not run["bsj_pairs"]:
        return None
    return 1e3 * run["spans"]["stage2"] / run["bsj_pairs"]
