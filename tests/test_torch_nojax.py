"""The torch port runs where neither JAX nor the reference is installed.

A subprocess blocks every ``jax`` and every ``circminer_tpu`` import with a
``sys.meta_path`` finder, imports every module of circminer_tpu_torch, and
runs the port's CLI on the CPU on a small make_synthetic-style dataset
(index, paired-end mapping under each executor, stage 2 on the host or the
device; single-end mapping; a --trace-dir run; tests/test_torch_distributed.py
runs its multi-host CLI the same way).  Its outputs must be
byte-equal to those of the reference CLI (``circminer_tpu.cli --device
native``, run in a process of its own) on the same inputs."""

import gzip
import json
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

import circminer_tpu_torch
from circminer_tpu.sim import make_genome, simulate_reads, write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = r'''
import importlib.abc, sys

class _NoJax(importlib.abc.MetaPathFinder):
    # jax, and the JAX reference package with every module in it
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "circminer_tpu"):
            raise ModuleNotFoundError(f"No module named {name!r} (blocked)")
        return None

sys.meta_path.insert(0, _NoJax())
'''

IMPORT_ALL = BLOCK_JAX + r'''
import importlib, pkgutil
import circminer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(circminer_tpu_torch.__path__,
                                               "circminer_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "circminer_tpu")]
assert not leaked, leaked
print("IMPORTED", len(names))
'''

RUN_CLI = BLOCK_JAX + r'''
from circminer_tpu_torch.cli import main
rc = main(sys.argv[1:])
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "circminer_tpu")]
assert not leaked, leaked
sys.exit(rc)
'''


def _env():
    # one intra-op thread: the CLI's tensors are tiny, and the test workers
    # share the cores
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _run(args, cwd, script=None):
    cmd = [sys.executable] + (["-c", script] if script else []) + args
    res = subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def test_port_sources_never_import_jax():
    pkg = os.path.dirname(circminer_tpu_torch.__file__)
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_every_port_module_imports_without_jax(tmp_path):
    res = _run([], tmp_path, IMPORT_ALL)
    n = int(res.stdout.split("IMPORTED")[1])
    mods = [m.name for m in pkgutil.walk_packages(
        circminer_tpu_torch.__path__, "circminer_tpu_torch.")
        if not m.name.endswith("__main__")]
    assert n == len(mods) >= 10
    assert {f"circminer_tpu_torch.{m}" for m in (
        "bench", "pipeline.circ", "ops.seed_host", "utils.timing",
        "config", "sim", "ops.filter_native", "pipeline.mapping",
        "parallel.distributed", "parallel.mesh", "graft_entry")} <= \
        set(mods)


def test_port_loads_no_jax_where_jax_is_installed(tmp_path, dataset):
    """With jax and the reference importable (as here), mapping through the
    port still loads neither."""
    script = IMPORT_ALL.replace(BLOCK_JAX, "import sys\n") + f"""
from circminer_tpu_torch.cli import main
d = {str(dataset)!r}
assert main(["--index", "-r", f"{{d}}/ref.fa", "-k", "20"]) == 0
assert main(["-r", f"{{d}}/ref.fa", "-g", f"{{d}}/ref.gtf", "-1",
             f"{{d}}/R1.fq", "-2", f"{{d}}/R2.fq", "-o", "out", "--device",
             "gpu-wave", "--torch-device", "cpu"]) == 0
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "circminer_tpu")]
assert not leaked, leaked
"""
    import importlib.util
    assert importlib.util.find_spec("jax") is not None
    assert importlib.util.find_spec("circminer_tpu") is not None
    _run([], tmp_path, script)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("nojax")
    rng = np.random.default_rng(42)
    g = make_genome(rng, length=20_000, n_genes=4)
    g.write_fasta(str(d / "ref.fa"))
    g.write_gtf(str(d / "ref.gtf"))
    reads, _ = simulate_reads(rng, g, 160, 40, read_len=100)
    write_fastq(reads, str(d / "R1.fq"), str(d / "R2.fq"))
    return d


def test_cli_without_jax_matches_reference_cli(dataset):
    d = dataset
    _run(["--index", "-r", "ref.fa", "-k", "20"], d, RUN_CLI)
    common = ["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq", "-2", "R2.fq",
              "--pam"]
    res = _run(common + ["-o", "port", "--device", "gpu-wave",
                         "--torch-device", "cpu"], d, RUN_CLI)
    assert "wave engine" in res.stderr
    # gpu-wave maps pairs with the auto lookup, as the reference's tpu-wave:
    # the probe runs (and caches nothing from the CPU)
    assert "auto executor: d2h" in res.stderr
    _run(["-m", "circminer_tpu.cli"] + common + ["-o", "ref", "--device",
                                                 "native"], d)
    for suffix in (".circ_report", ".mapping.pam"):
        got = (d / ("port" + suffix)).read_bytes()
        want = (d / ("ref" + suffix)).read_bytes()
        assert got == want, suffix
    assert (d / "ref.mapping.pam").read_bytes().count(b"\n") == 200
    assert (d / "ref.circ_report").stat().st_size > 0


@pytest.fixture(scope="module")
def native_outputs(dataset):
    """The reference CLI's --device native outputs on the dataset."""
    d = dataset
    _run(["--index", "-r", "ref.fa", "-k", "20"], d, RUN_CLI)
    _run(["-m", "circminer_tpu.cli", "-r", "ref.fa", "-g", "ref.gtf", "-1",
          "R1.fq", "-2", "R2.fq", "--pam", "-o", "native", "--device",
          "native"], d)
    return {s: (d / ("native" + s)).read_bytes()
            for s in (".circ_report", ".mapping.pam", ".candidates.pam")}


@pytest.mark.parametrize("device,tag", [("gpu-chain", "mapping done"),
                                        ("gpu-full", "device-full: 200 reads"),
                                        ("native", "mapping done")])
def test_cli_without_jax_chain_and_full_match_native(dataset, native_outputs,
                                                     device, tag):
    """The device-chain and fused device-full executors, and the port's own
    native executor (its C++ engines built from circminer_tpu_torch/native),
    through the port's CLI with jax and the reference blocked (64-pair
    batches keep the CPU run short); gpu-full also runs the stage-2
    extension DPs on the torch device."""
    d = dataset
    res = _run(["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq", "-2",
                "R2.fq", "--pam", "-o", device, "--device", device,
                "--torch-device", "cpu", "--batch-size", "64"], d, RUN_CLI)
    assert tag in res.stderr
    assert ("stage-2 device extension" in res.stderr) == \
        (device == "gpu-full")
    for suffix, want in native_outputs.items():
        assert (d / (device + suffix)).read_bytes() == want, suffix


@pytest.fixture(scope="module")
def native_band0(dataset):
    """The reference CLI's --device native outputs at -w 0."""
    d = dataset
    _run(["--index", "-r", "ref.fa", "-k", "20"], d, RUN_CLI)
    _run(["-m", "circminer_tpu.cli", "-r", "ref.fa", "-g", "ref.gtf", "-1",
          "R1.fq", "-2", "R2.fq", "--pam", "-w", "0", "-o", "native_w0",
          "--device", "native"], d)
    return {s: (d / ("native_w0" + s)).read_bytes()
            for s in (".circ_report", ".mapping.pam")}


@pytest.mark.parametrize("device", ["gpu-wave", "gpu-full"])
def test_cli_at_band_zero_matches_native(dataset, native_band0, device):
    """-w 0 through the port's CLI with jax blocked: the wave service (under
    gpu-wave, and stage 2 under gpu-full) warms up and answers inside the
    one_side kernel's bound, byte-equal to the reference's native run."""
    d = dataset
    _run(["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq", "-2", "R2.fq",
          "--pam", "-w", "0", "-o", f"w0_{device}", "--device", device,
          "--torch-device", "cpu", "--batch-size", "64"], d, RUN_CLI)
    for suffix, want in native_band0.items():
        assert (d / (f"w0_{device}" + suffix)).read_bytes() == want, suffix


@pytest.fixture(scope="module")
def native_se_output(dataset):
    """The reference CLI's single-end --device native mapping of R1.fq."""
    d = dataset
    _run(["--index", "-r", "ref.fa", "-k", "20"], d, RUN_CLI)
    _run(["-m", "circminer_tpu.cli", "-r", "ref.fa", "-g", "ref.gtf", "-s",
          "R1.fq", "--pam", "-o", "native_se", "--device", "native"], d)
    out = (d / "native_se.mapping.pam").read_bytes()
    assert out.count(b"\n") == 200
    return out


@pytest.mark.parametrize("device", ["gpu-full", "auto", "host"])
def test_cli_single_end_matches_reference(dataset, native_se_output, device):
    """-s through the port's CLI with jax blocked: gpu-full (host lookup,
    device chain DP), auto (device or native, probed) and host (the
    per-read oracle) byte-equal to the reference's native SE mapping."""
    d = dataset
    res = _run(["-r", "ref.fa", "-g", "ref.gtf", "-s", "R1.fq", "--pam",
                "-o", f"se_{device}", "--device", device, "--torch-device",
                "cpu", "--batch-size", "64"], d, RUN_CLI)
    assert "SE mapping done: 200 reads" in res.stderr
    if device == "auto":
        assert "auto executor: d2h" in res.stderr
    assert (d / f"se_{device}.mapping.pam").read_bytes() == native_se_output


def test_cli_trace_dir_writes_a_trace(dataset, native_outputs):
    """--trace-dir with jax blocked: a gzipped Chrome trace holding the
    device lookup's cm.lookup span; the outputs stay byte-equal to native.
    (chip_smoke.py traces gpu-full on the card: cm.walk_waves and the
    kernels.)"""
    d = dataset
    res = _run(["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq", "-2",
                "R2.fq", "--pam", "-o", "traced", "--device", "gpu",
                "--torch-device", "cpu", "--trace-dir", "tr"], d, RUN_CLI)
    assert "trace written to" in res.stderr
    (trace,) = (d / "tr").iterdir()
    assert trace.name.endswith(".trace.json.gz")
    with gzip.open(trace, "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "cm.lookup" in names
    for suffix, want in native_outputs.items():
        assert (d / ("traced" + suffix)).read_bytes() == want, suffix


def test_device_trace_follows_the_environment(tmp_path, monkeypatch):
    import torch
    from circminer_tpu_torch.utils.timing import device_trace
    monkeypatch.delenv("CIRCMINER_TRACE_DIR", raising=False)
    with device_trace():
        torch.ones(3).add(1)
    monkeypatch.setenv("CIRCMINER_TRACE_DIR", str(tmp_path / "env"))
    with device_trace():
        with torch.profiler.record_function("cm.test"):
            torch.ones(3).add(1)
    (trace,) = (tmp_path / "env").iterdir()
    with gzip.open(trace, "rt") as f:
        assert "cm.test" in {e.get("name")
                             for e in json.load(f)["traceEvents"]}
