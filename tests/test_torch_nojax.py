"""The torch port runs where JAX is not installed.

A subprocess blocks every ``jax`` import with a ``sys.meta_path`` finder,
imports every module of circminer_tpu_torch, and runs the port's CLI on the
CPU on a small make_synthetic-style dataset (index, gpu-wave mapping, stage
2).  Its circ_report and mapping.pam must be byte-equal to those of the
reference CLI (``circminer_tpu.cli --device native``) on the same inputs."""

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
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
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
import circminer_tpu.ops.chain as chain
assert chain.__name__ == "circminer_tpu_torch.ops.chain", chain.__name__
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
assert not leaked, leaked
print("IMPORTED", len(names))
'''

RUN_CLI = BLOCK_JAX + r'''
from circminer_tpu_torch.cli import main
rc = main(sys.argv[1:])
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
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
    mods = [m for m in pkgutil.walk_packages(circminer_tpu_torch.__path__,
                                             "circminer_tpu_torch.")
            if not m.name.endswith("__main__")]
    assert n == len(mods) >= 10


def test_port_loads_no_jax_where_jax_is_installed(tmp_path, dataset):
    """With jax importable (as here), mapping through the port still
    loads none of it: the guard keeps the reference's jax-backed chain
    module out."""
    script = IMPORT_ALL.replace(BLOCK_JAX, "import sys\n") + f"""
from circminer_tpu_torch.cli import main
d = {str(dataset)!r}
assert main(["--index", "-r", f"{{d}}/ref.fa", "-k", "20"]) == 0
assert main(["-r", f"{{d}}/ref.fa", "-g", f"{{d}}/ref.gtf", "-1",
             f"{{d}}/R1.fq", "-2", f"{{d}}/R2.fq", "-o", "out", "--device",
             "gpu-wave", "--torch-device", "cpu"]) == 0
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
assert not leaked, leaked
"""
    import importlib.util
    assert importlib.util.find_spec("jax") is not None
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
            for s in (".circ_report", ".mapping.pam")}


@pytest.mark.parametrize("device,tag", [("gpu-chain", "mapping done"),
                                        ("gpu-full", "device-full: 200 reads")])
def test_cli_without_jax_chain_and_full_match_native(dataset, native_outputs,
                                                     device, tag):
    """The device-chain and fused device-full executors through the port's
    CLI with jax blocked (64-pair batches keep the CPU run short)."""
    d = dataset
    res = _run(["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq", "-2",
                "R2.fq", "--pam", "-o", device, "--device", device,
                "--torch-device", "cpu", "--batch-size", "64"], d, RUN_CLI)
    assert tag in res.stderr
    for suffix, want in native_outputs.items():
        assert (d / (device + suffix)).read_bytes() == want, suffix


def test_cli_refuses_what_is_not_ported(dataset, capsys):
    from circminer_tpu_torch.cli import main
    d = str(dataset)
    argv = ["-r", f"{d}/ref.fa", "-g", f"{d}/ref.gtf", "--torch-device", "cpu"]
    assert main(argv + ["-s", f"{d}/R1.fq"]) == 2
    assert "single-end mapping (-s) is not ported" in capsys.readouterr().err
    assert main(argv + ["-1", f"{d}/R1.fq", "-2", f"{d}/R2.fq",
                        "--trace-dir", f"{d}/tr"]) == 2
    assert "--trace-dir is not ported" in capsys.readouterr().err
