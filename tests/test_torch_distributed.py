"""Multi-host runs of the port (``circminer_tpu_torch/parallel/
distributed.py`` and the CLI path it drives), mirroring
tests/test_distributed.py: striped mapping shards, per-host outputs and
host 0's stage 2 over every shard give the single-host circ_report, byte
for byte.  The port's CLI runs in subprocesses with jax and the reference
blocked (``test_torch_nojax.RUN_CLI``)."""

import socket
import subprocess
import sys

import numpy as np
import pytest

from circminer_tpu.parallel import distributed as jdist
from circminer_tpu.sim import make_genome, simulate_reads, write_fastq
from circminer_tpu_torch.parallel import distributed as tdist
from test_torch_nojax import RUN_CLI, _env, _run


def test_stripe_and_prefix_equal_the_reference():
    items = list(range(10))
    for n in (1, 2, 3, 4):
        for h in range(n):
            for idx in (False, True):
                assert list(tdist.stripe_pairs(items, h, n, idx)) == \
                    list(jdist.stripe_pairs(items, h, n, idx))
            assert tdist.shard_output_prefix("out", h, n) == \
                jdist.shard_output_prefix("out", h, n)
    assert list(tdist.stripe_pairs(items, 1, 3)) == [1, 4, 7]
    assert list(tdist.stripe_pairs(items, 1, 3, with_index=True))[0] == (1, 1)
    assert tdist.shard_output_prefix("out", 1, 2) == "out.h1"


def test_maybe_initialize_without_a_coordinator_is_a_no_op(monkeypatch):
    import torch.distributed as dist
    for var in ("CIRCMINER_COORDINATOR", "CIRCMINER_NUM_HOSTS",
                "CIRCMINER_HOST_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.maybe_initialize() == (0, 1)
    monkeypatch.setenv("CIRCMINER_NUM_HOSTS", "3")
    monkeypatch.setenv("CIRCMINER_HOST_ID", "2")
    assert tdist.maybe_initialize() == (2, 3)
    assert tdist.maybe_initialize(None, 4, 1) == (1, 4)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_distributed.py's coordinated dataset (25 kbp, 200 pairs,
    30% circular), its index, and the reference CLI's single-host
    --device native circ_report."""
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(77)
    g = make_genome(rng, length=25_000, n_genes=4)
    g.write_fasta(str(d / "ref.fa"))
    g.write_gtf(str(d / "ref.gtf"))
    reads, _ = simulate_reads(rng, g, 140, 60, read_len=100)
    write_fastq(reads, str(d / "R1.fq"), str(d / "R2.fq"))
    _run(["--index", "-r", "ref.fa", "-k", "20"], d, RUN_CLI)
    _run(["-m", "circminer_tpu.cli"] + BASE + ["-o", "single", "--device",
                                                "native"], d)
    want = (d / "single.circ_report").read_bytes()
    assert want, "the single-host run found no events"
    return d, want


BASE = ["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq", "-2", "R2.fq"]


@pytest.mark.parametrize("device", ["native", "gpu-full"])
def test_two_sequential_hosts_match_the_single_host(dataset, device):
    """Host 1 maps its stripe only; host 0 maps its own, then merges every
    host's remain shard for stage 2 (shared directory, no coordinator)."""
    d, want = dataset
    args = BASE + ["-o", f"seq_{device}", "--device", device,
                   "--torch-device", "cpu", "--batch-size", "64",
                   "--num-hosts", "2"]
    res1 = _run(args + ["--host-id", "1"], d, RUN_CLI)
    assert "host 1 of 2" in res1.stderr
    assert not (d / f"seq_{device}.circ_report").exists()
    assert (d / f"seq_{device}.h1_1_remain.done").exists()
    _run(args + ["--host-id", "0"], d, RUN_CLI)
    assert (d / f"seq_{device}.circ_report").read_bytes() == want
    n = [(d / f"seq_{device}.h{h}.mapping.pam").exists() for h in (0, 1)]
    assert n == [False, False]     # no --pam: no mapping output per host


def test_cli_in_process_keeps_the_callers_group(dataset, monkeypatch):
    """cli.main in a process that already holds a process group: the run
    calls its hooks in order, writes the single-host circ_report, and
    leaves the caller's group initialized."""
    import torch.distributed as dist
    from circminer_tpu_torch import cli
    d, want = dataset
    monkeypatch.chdir(d)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    seen = []
    try:
        hooks = {p: (lambda obj, p=p: seen.append((p, type(obj).__name__)))
                 for p in ("mapping", "mapped", "called")}
        assert cli.main(BASE + ["-o", "inproc", "--device", "native"],
                        hooks) == 0
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert seen == [("mapping", "DeviceMappingPipeline"),
                    ("mapped", "DeviceMappingPipeline"),
                    ("called", "ProcessCirc")]
    assert (d / "inproc.circ_report").read_bytes() == want


def test_two_coordinated_processes_match_the_single_host(dataset):
    """Two concurrent processes joined in one gloo process group through
    --coordinator (distributed.py's init_process_group), as the
    reference's test runs two under jax.distributed."""
    d, want = dataset
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-c", RUN_CLI] + BASE + [
        "-o", "coord", "--device", "native", "--pam", "--coordinator",
        f"127.0.0.1:{port}", "--num-hosts", "2"]
    procs = [subprocess.Popen(cmd + ["--host-id", str(h)], cwd=d, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for h in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for h, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        assert f"host {h} of 2 (gloo process group)" in err
    assert (d / "coord.circ_report").read_bytes() == want
    # each host wrote its own stripe of the mapping
    lines = [(d / f"coord.h{h}.mapping.pam").read_bytes().count(b"\n")
             for h in (0, 1)]
    assert lines == [100, 100]
