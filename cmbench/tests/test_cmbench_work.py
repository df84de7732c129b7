"""The frozen work counts (``cmbench/work/``) against ``chip_smoke.py``'s:
equal bounds on the inputs recorded from one eager gpu-full step at a
tiny size, and on drawn DP-kernel inputs."""

import numpy as np
import pytest

import chip_smoke
from cmbench import inputs, run
from cmbench.work import counts, record
from conftest import ENRICHED, TINY


@pytest.fixture(scope="module")
def recorded(cache, tmp_path_factory):
    """The inputs of one eager gpu-full step over a tiny library's first
    batch, recorded on the CPU."""
    import torch
    d = str(tmp_path_factory.mktemp("work"))
    fa, _ = inputs.genome_files("tiny", TINY)
    libs = inputs.write_libraries(fa, TINY, ENRICHED, 77, d)
    fa, gtf = inputs.genome_files("tiny", TINY)
    prog = run.Program(TINY, torch.device("cpu"), "tiny", fa, gtf)
    dp, tensors = {}, {}
    with record.recording(dp, tensors):
        prog.library_pass(libs[0], d + "/rec", limit=prog.pipe.batch)
    return dp, tensors


def test_tensor_kernel_bounds_equal_the_smokes(recorded, one_thread):
    _, tensors = recorded
    names = {name for name, _ in tensors}
    assert {"chain_cells", "chain_dp", "extract_kbest", "mr_pair_fold",
            "walk_init", "pair_grid", "extend_core"} <= names
    for (name, rows), rec in sorted(tensors.items()):
        got = counts.tensor_kernel_bound(name, rec["args"], rec["kw"])
        want = chip_smoke.tensor_kernel_bound(name, rec["args"], rec["kw"])
        assert got == want, (name, rows)
        assert got[0] > 0


@pytest.mark.parametrize("name", ["xdrop", "edit_sc", "edit_end",
                                  "one_side"])
def test_dp_bounds_equal_the_smokes(name):
    rng = np.random.default_rng(3)
    B, L, w = 64, 40, 3
    s = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = rng.integers(0, 4, (B, L)).astype(np.int8)
    t[::3] = s[::3]
    n = rng.integers(0, L + 1, B).astype(np.int32)
    m = rng.integers(0, L + 1, B).astype(np.int32)
    wv = rng.integers(0, 4, B).astype(np.int32)
    sm = record.ScoreMat(2, -4, -4, 20)
    got = counts.work(name, s, t, n, m, wv, w, sm)
    assert got == chip_smoke.work(name, s, t, n, m, wv, w, sm)
    cols = record.DP_COLUMNS[name]
    assert counts.bounds(name, B, L, cols, *got) == \
        chip_smoke.bounds(name, B, L, cols, *got)


def test_map_bounds_count_every_launch_on_its_own_inputs(cache, tmp_path,
                                                         one_thread):
    """Over a whole library in eager steps: a bound for each kernel the
    recorder saw, one step a batch; and over one batch, each kernel
    launched once a step has the bound of its kept inputs."""
    import torch
    fa, gtf = inputs.genome_files("tiny", TINY)
    libs = inputs.write_libraries(fa, TINY, ENRICHED, 78, str(tmp_path))
    prog = run.Program(TINY, torch.device("cpu"), "tiny", fa, gtf)
    got = prog.map_bounds(libs[1])
    batches = -(-TINY["library_pairs"] // TINY["pipeline"]["batch_size"])
    assert got["steps"] == batches
    # the DP kernels go through _ext.launch on the card only
    assert {"chain_cells", "chain_dp", "extract_kbest",
            "pair_grid"} <= set(got["bounds"])
    assert all(v > 0 for v in got["bounds"].values())
    dp, tensors, one = {}, {}, {}
    with record.recording(dp, tensors, one):
        prog.library_pass(libs[1], str(tmp_path / "one"),
                          limit=prog.pipe.batch)
    assert set(one) == {name for name, _ in list(dp) + list(tensors)}
    for name in ("chain_cells", "extract_kbest", "pair_grid"):
        (_, entry), = [(k, e) for k, e in tensors.items() if k[0] == name]
        assert entry["count"] == 1
        assert one[name] == counts.tensor_kernel_bound(
            name, entry["args"], entry["kw"])[0]
