"""The control of ``correct``: the reference put in the program's place
with one guarantee of the configuration broken, its edit-distance limit
one below the configuration's (``-e 3`` for ``-e 4``: the cut that would
tempt a change that wants fewer DP cells), at a cell's own size.

    python3 -m cmbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed it draws the cell's libraries as a run does, computes the
reference's outputs and the control's, and prints one JSON line of the
numbers that ``compare.py`` compares (over one pass of each library) beside
their limits.  The control has to exceed a limit on every seed.  It runs
on the host alone; the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

from cmbench import compare, inputs, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cmbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    w, config, traffic = inputs.cell(inputs.load_benchmark(), args.workload)
    fa, gtf = inputs.genome_files(w["config"], config)
    change = {"max_ed": config["config"]["max_ed"] - 1}
    failed_all = True
    for seed in args.seeds:
        d = tempfile.mkdtemp(prefix="cmbench_control_")
        try:
            libs = inputs.write_libraries(fa, config, traffic, seed, d)
            want = run.reference_outputs(config, w["config"], fa, gtf, libs,
                                         d)
            got = run.reference_outputs(config, w["config"], fa, gtf, libs,
                                        d, cfg_change=change)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        order = sorted(got)
        checks = compare.judge([got[i] for i in order], order, want)
        fails = any(v > compare.LIMITS[k] for k, v in checks.items())
        failed_all &= fails
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              control=change, not_correct=fails,
                              checks={k: dict(value=v,
                                              limit=compare.LIMITS[k])
                                      for k, v in checks.items()})),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
