"""The torch port's bench (``python -m circminer_tpu_torch.bench``) with jax
and the reference package blocked, on the CPU, against the reference's root
``bench.py``.

Small runs of the reference bench's smoke configuration (100 kbp genome,
128 pairs, 64-pair batches): the port's gpu-full (with the stage-2 device
extension, two repeats and one), the port's native, and the reference's
native.  Each prints one JSON line with the reference's keys and the same
events; the two-repeat run reports the statistics of one run (128 reads
through the fused step, deferral equal to the one-repeat run's)."""

import json
import os
import subprocess
import sys

import pytest

from test_torch_nojax import BLOCK_JAX, REPO

RUN_BENCH = BLOCK_JAX + r'''
from circminer_tpu_torch.bench import main
rc = main(sys.argv[1:])
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "circminer_tpu")]
assert not leaked, leaked
sys.exit(rc)
'''
SMALL = ["--smoke", "--n-reads", "128", "--batch", "64"]
# the keys of every line of the reference bench (bench.py:329-343), and
# those it adds for repeats and the fused step (bench.py:344-352)
KEYS = {"metric", "value", "unit", "vs_baseline", "executor", "backend",
        "n_pairs", "genome_len", "events", "true_events", "events_matched",
        "phases"}
REPEAT_KEYS = {"runs", "spread_pct"}
FULL_KEYS = {"deferred_pct", "defer_causes"}


def _start(cmd, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", HOME=str(tmp_path))
    return subprocess.Popen([sys.executable, *cmd], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0]), err


def test_bench_prints_the_reference_json(tmp_path):
    port = ["-c", RUN_BENCH, *SMALL, "--torch-device", "cpu"]
    procs = {
        "full2": _start(port + ["--exec", "gpu-full", "--repeat", "2",
                                "--circ-device"], tmp_path),
        "full1": _start(port + ["--exec", "gpu-full", "--repeat", "1"],
                        tmp_path),
        "native": _start(port + ["--exec", "native"], tmp_path),
        "ref": _start([os.path.join(REPO, "bench.py"), *SMALL, "--cpu",
                       "--exec", "native"], tmp_path),
    }
    res = {k: _result(p) for k, p in procs.items()}
    (full2, err2), (full1, _) = res["full2"], res["full1"]
    (native, _), (ref, _) = res["native"], res["ref"]

    assert set(ref) == KEYS
    assert set(native) == KEYS
    assert set(full1) == KEYS | FULL_KEYS
    assert set(full2) == KEYS | FULL_KEYS | REPEAT_KEYS
    assert set(full2["phases"]) == set(ref["phases"])
    assert full2["metric"] == ref["metric"] == \
        "pe_reads_per_sec_chip_map_call"
    assert (full2["executor"], full2["backend"]) == ("gpu-full", "cpu")
    assert native["executor"] == "native"
    for k in ("n_pairs", "genome_len", "events", "true_events",
              "events_matched"):
        assert full2[k] == full1[k] == native[k] == ref[k], k
    assert ref["events"] > 0 and ref["n_pairs"] == 128
    assert len(full2["runs"]) == 2 and full2["value"] == max(full2["runs"])
    # statistics are reset per repeat: one run's 128 reads, not 256
    assert (full2["deferred_pct"], full2["defer_causes"]) == \
        (full1["deferred_pct"], full1["defer_causes"])
    assert "[bench] device-full: 128 reads," in err2
    assert "[bench] stage-2 device extension:" in err2


@pytest.mark.cuda
def test_bench_on_card_matches_native(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the bench there)")
    port = ["-c", RUN_BENCH, *SMALL]
    full = _start(port + ["--exec", "gpu-full", "--circ-device"], tmp_path)
    (got, _), (want, _) = _result(full), _result(
        _start(port + ["--exec", "native"], tmp_path))
    assert got["backend"] == "cuda"
    assert (got["events"], got["events_matched"]) == \
        (want["events"], want["events_matched"])
