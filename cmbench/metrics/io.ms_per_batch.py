"""io: host ms a 4,096-pair batch spends in ``read_pairs``, the FASTQ
iterator that the harness hands to ``map_stream`` (its span around each
pull, summed over the window)."""


def read(run):
    if "io" not in run["spans"] or not run["pairs"]:
        return None
    return 1e3 * run["spans"]["io"] / (run["pairs"] / 4096)
