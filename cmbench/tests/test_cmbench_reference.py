"""The frozen reference against the port's host-only native path, and the
control that it has to catch.

At a tiny genome the reference (``cmbench/reference/``: host C++ mapping
with every core, host stage 2) gives every pair the same MatchedRead as
the port's ``--device native`` executor at one thread, and the same
events, candidate lines and ``circ_report`` bytes.  Its control, the
reference with the edit-distance limit one below the configuration's,
has to differ from it."""

import os

import pytest

from cmbench import compare, inputs, run
from conftest import ENRICHED, TINY

TINY_REF = {**TINY, "library_pairs": 1200}


@pytest.fixture(scope="module")
def libraries(cache, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("libs"))
    fa, gtf = inputs.genome_files("tiny", TINY_REF)
    libs = inputs.write_libraries(fa, TINY_REF, ENRICHED, 20261018, d)
    return fa, gtf, libs, d


def port_native(fa, gtf, libs, out_dir):
    """The port's native executor and host stage 2 over each library."""
    import circminer_tpu_torch as port
    from circminer_tpu_torch.config import CHI2BSJ, CHIBSJ
    from circminer_tpu_torch.io.fastq import read_pairs
    from circminer_tpu_torch.pipeline.circ import ProcessCirc
    from circminer_tpu_torch.pipeline.device_pipeline import \
        DeviceMappingPipeline
    cfg = inputs.run_config(port, TINY_REF)
    gi, db = inputs.indexed("port", port, "tiny", TINY_REF, cfg, fa, gtf)
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=64,
                                 chain_exec="native", extend_exec="native")
    out = {}
    for i, lib in enumerate(libs):
        recs = list(read_pairs(lib["r1"], lib["r2"], cfg))
        pipe.map_stream(iter(recs))
        bsj = [(r1, r2) for r1, r2 in recs
               if r1.mr.type in (CHIBSJ, CHI2BSJ)]
        for r1, _ in bsj:
            r1.mr.genome_spos = r1.mr.spos_r1
        bsj.sort(key=lambda pr: pr[0].mr.genome_spos)
        path = os.path.join(out_dir, f"port{i}.circ_report")
        pc = ProcessCirc(db, gi, cfg, path, device="cpu")
        pc.run(bsj)
        pc.report_events(path)
        with open(path, "rb") as f:
            out[i] = compare.outputs([r1.mr for r1, _ in recs],
                                     pc.circ_res, pc.candid_lines, f.read(),
                                     keep_states=True)
    return out


def test_reference_equals_port_native(libraries):
    fa, gtf, libs, d = libraries
    want = port_native(fa, gtf, libs, d)
    got = run.reference_outputs(TINY_REF, "tiny", fa, gtf, libs, d)
    for i in want:
        assert len(got[i].states) == TINY_REF["library_pairs"]
        assert got[i].states == want[i].states
        assert (got[i].pairs == want[i].pairs).all()
        assert got[i].events == want[i].events
        assert got[i].report == want[i].report
    # the library calls something: the comparison is not of empty files
    assert all(w.report for w in want.values())


def test_control_fails(libraries):
    """The reference with max_ed one lower (a guarantee of the
    configuration broken) put in the program's place: not correct."""
    fa, gtf, libs, d = libraries
    want = run.reference_outputs(TINY_REF, "tiny", fa, gtf, libs, d)
    control = run.reference_outputs(TINY_REF, "tiny", fa, gtf, libs, d,
                                    cfg_change={"max_ed": 3})
    bad = compare.judge([control[0], control[1]], [0, 1], want)
    assert bad["pair_mismatches"] > compare.LIMITS["pair_mismatches"]
