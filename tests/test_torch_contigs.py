"""Multi-contig rounds in the torch port, held to the reference on the CPU.

The world is tests/test_streaming.py's: two 30 kbp chromosomes packed into
two contigs (``GenomePacker(ref, contig_size=35_000)``), 26 pairs from
each.  Every paired-end executor maps through both rounds
(``map_stream_all_contigs``: reads not finished in round 0 are carried
through the remain-FASTQ files with their MatchedRead state and global
ordinal), single-end reads go through both contigs per batch, and the CLI
runs under ``CIRCMINER_CONTIG_SIZE``.  Batches of 16 pairs leave partial
batches in both rounds; the fused step's DP pools are shrunk identically
for both packages.  Exact comparisons (tolerance 0)."""

import numpy as np
import pytest
import torch

from circminer_tpu.annotation.annotation import AnnotationDB
from circminer_tpu.config import CONCRD, Config
from circminer_tpu.index.build import build_genome_index
from circminer_tpu.io.fasta import GenomePacker
from circminer_tpu.ops import device_full as jfull
from circminer_tpu.pipeline.device_pipeline import \
    DeviceMappingPipeline as JaxPipeline
from circminer_tpu.sim import make_genome, simulate_reads, write_fastq
from circminer_tpu_torch.pipeline import device_pipeline as tpipe
from test_device_full import FIELDS, make_pairs
from test_extend_batch import _key
from test_se_mapping import make_rec
from test_torch_full import SMALL_POOLS, small_pools
from test_torch_nojax import RUN_CLI, _env
from test_torch_selfcontained import port_config

BATCH = 16
# the port's executors: (chain_exec, extend_exec); gpu-wave = auto + waves
PE_EXECUTORS = {"native": ("native", "native"), "gpu": ("device", "native"),
                "gpu-chain": ("device-chain", "native"),
                "gpu-full": ("device-full", "native"),
                "gpu-wave": ("auto", "device"), "auto": ("auto", "native")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_chromosomes(d, rng, n_linear, n_circ):
    """ref.fa / ref.gtf with chr1 and chr2 (30 kbp, 2 genes each) and
    simulated pairs of both, named apart."""
    g = make_genome(rng, length=30_000, n_genes=2, chrom="chr1")
    g2 = make_genome(rng, length=30_000, n_genes=2, chrom="chr2")
    ref, gtf = str(d / "ref.fa"), str(d / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    g2.write_fasta(ref, append=True)
    g2.write_gtf(gtf, append=True)
    reads1, _ = simulate_reads(rng, g, n_linear, n_circ)
    reads2, _ = simulate_reads(rng, g2, n_linear, n_circ)
    for r in reads2:
        r.name = r.name + "b"
    return ref, gtf, reads1 + reads2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("contigs")
    ref, gtf, reads = _two_chromosomes(d, np.random.default_rng(11), 20, 6)
    cfg = Config(kmer=20, max_read_len=100)
    contigs, info = GenomePacker(ref, contig_size=35_000).pack_genome()
    assert len(contigs) == 2
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                               contig_lengths=[len(c) for c in contigs])
    return cfg, gi, db, reads


def _pairs(reads, cfg):
    pairs = make_pairs(reads, cfg)
    for k, (r1, _) in enumerate(pairs):
        r1.ordinal = k
    return pairs


def _fields(mr):
    return tuple(getattr(mr, f) for f in FIELDS)


def _port(world, executor, scan_level=0):
    cfg, gi, db, _ = world
    chain_exec, extend_exec = PE_EXECUTORS[executor]
    pcfg = port_config(Config(**{**cfg.__dict__, "scan_level": scan_level}))
    pipe = tpipe.DeviceMappingPipeline(db, gi, pcfg, batch_size=BATCH,
                                       chain_exec=chain_exec,
                                       extend_exec=extend_exec, device="cpu")
    return small_pools(pipe) if chain_exec == "device-full" else pipe


class _Sink:
    """A mapping output that keeps each emitted pair's MatchedRead."""
    fmt = "pam"

    def __init__(self):
        self.emitted = {}

    def write_pam_pe(self, r1, r2):
        self.emitted[r1.rname] = _fields(r1.mr)


def _streamed(pipe, reads, cfg, tmp):
    pipe.warmup()
    sink = _Sink()
    n = pipe.map_stream_all_contigs(iter(_pairs(reads, cfg)), out=sink,
                                    workdir=str(tmp))
    assert n == len(reads) == len(sink.emitted)
    return sink.emitted


@pytest.fixture(scope="module")
def reference(world, tmp_path_factory):
    """The reference pipeline's native rounds at scan levels 0 and 1."""
    cfg, gi, db, reads = world
    out = {}
    for level in (0, 1):
        c = Config(**{**cfg.__dict__, "scan_level": level})
        out[level] = _streamed(JaxPipeline(db, gi, c, batch_size=BATCH,
                                           chain_exec="native"),
                               reads, c, tmp_path_factory.mktemp("ref"))
    return out


@pytest.mark.parametrize("executor", sorted(PE_EXECUTORS))
def test_streamed_rounds_equal_materialized_passes(world, reference,
                                                   executor, tmp_path):
    """tests/test_streaming.py for every executor: the disk-carried rounds
    equal one pass per contig over an in-memory pair list, and every pair's
    MatchedRead equals the reference's native rounds."""
    cfg, gi, db, reads = world
    mat = _pairs(reads, cfg)
    pipe = _port(world, executor)
    pipe.warmup()
    for c in range(2):
        todo = [pr for pr in mat if pr[0].mr.type != CONCRD] if c else mat
        pipe.map_stream(iter(todo), contig=c)
    want = {pr[0].rname: _fields(pr[0].mr) for pr in mat}
    got = _streamed(_port(world, executor), reads, cfg, tmp_path)
    assert got == want
    bad = [(k, v, reference[0][k]) for k, v in got.items()
           if v != reference[0][k]]
    assert not bad, bad[:3]
    # both rounds mapped pairs: chr2's are concordant only on contig 2
    conc = [sum(v[0] == CONCRD for k, v in got.items()
                if k.endswith("b") == chr2) for chr2 in (False, True)]
    assert min(conc) > 10, conc


@pytest.mark.parametrize("executor", ["native", "gpu-full"])
def test_scan_level_one_rounds_match_the_reference(world, reference,
                                                   executor, tmp_path):
    """At scan level 1 only a perfect concordant pair skips the second
    round, so more pairs are carried with their state."""
    cfg, gi, db, reads = world
    got = _streamed(_port(world, executor, scan_level=1), reads,
                    Config(**{**cfg.__dict__, "scan_level": 1}), tmp_path)
    assert got == reference[1]


@pytest.mark.parametrize("chain_exec", ["native", "device", "device-chain",
                                        "device-full"])
def test_single_end_over_two_contigs_matches_the_reference(world,
                                                           chain_exec):
    cfg, gi, db, reads = world
    seqs = [r.r1 for r in reads]
    port = tpipe.DeviceMappingPipeline(db, gi, port_config(cfg),
                                       batch_size=BATCH,
                                       chain_exec=chain_exec, device="cpu")
    ref = JaxPipeline(db, gi, cfg, batch_size=BATCH, chain_exec="native")
    got, want = [], []
    for pipe, out in ((port, got), (ref, want)):
        recs = [make_rec(cfg, q) for q in seqs]
        pipe.warmup()
        assert pipe.map_stream_se(iter(recs)) == len(seqs)
        out.extend(_key(r.mr) for r in recs)
    assert got == want
    assert sum(k[0] == CONCRD for k in got) >= 30


def test_gpu_full_round_blobs_match_jax(world, tmp_path, monkeypatch):
    """The fused step of every batch of both rounds: the same inputs (the
    carried MatchedRead rows of round 1 included) and the same int32 blob
    in the port as in JAX's tpu-full pipeline."""
    cfg, gi, db, reads = world
    seen = {"port": [], "jax": []}

    def spy(step, key, as_np):
        def run(seqs, lens, mr_in, *args, contig_num, **kw):
            blob = step(seqs, lens, mr_in, *args, contig_num=contig_num,
                        **kw)
            seen[key].append((contig_num, as_np(seqs), as_np(mr_in),
                              as_np(blob)))
            return blob
        return run

    monkeypatch.setattr(tpipe, "device_full_step",
                        spy(tpipe.device_full_step, "port",
                            lambda t: t.numpy().copy()))
    monkeypatch.setattr(jfull, "device_full_step",
                        spy(jfull.device_full_step, "jax", np.asarray))
    _streamed(_port(world, "gpu-full"), reads, cfg, tmp_path / "port")
    jp = JaxPipeline(db, gi, cfg, batch_size=BATCH, chain_exec="device-full")
    statics = jp._full_statics
    jp._full_statics = lambda: {**statics(), **SMALL_POOLS}
    _streamed(jp, reads, cfg, tmp_path / "jax")
    port, ref = seen["port"], seen["jax"]
    assert [c for c, *_ in port] == [c for c, *_ in ref]
    assert {c for c, *_ in port} == {0, 1}
    for i, ((c, s, m, b), (_, s2, m2, b2)) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(s, s2, err_msg=f"step {i} seqs")
        np.testing.assert_array_equal(m, m2, err_msg=f"step {i} mr_in")
        assert b.dtype == b2.dtype == np.int32
        bad = np.nonzero((b != b2).any(axis=1))[0]
        assert not len(bad), (i, c, bad[:3], b[bad[:2]], b2[bad[:2]])
    # round 1 carries touched state from round 0 into some rows
    default = port[0][2][-1]
    assert any((m != default).any(axis=1).any() for c, _, m, _ in port
               if c == 1)


@pytest.fixture(scope="module")
def cli_dataset(tmp_path_factory):
    """Two chromosomes (60 + 30 pairs each), indexed into two contigs by
    CIRCMINER_CONTIG_SIZE, and the reference CLI's --device native
    outputs."""
    d = tmp_path_factory.mktemp("contigs_cli")
    _, _, reads = _two_chromosomes(d, np.random.default_rng(23), 60, 30)
    write_fastq(reads, str(d / "R1.fq"), str(d / "R2.fq"))
    env = dict(_env(), CIRCMINER_CONTIG_SIZE="35000")
    res = _cli(["--index", "-r", "ref.fa", "-k", "20"], d, env, RUN_CLI)
    assert "over 2 contig(s)" in res.stderr
    _cli(["-m", "circminer_tpu.cli"] + CLI_ARGS + ["-o", "ref", "--device",
                                                   "native"], d, env)
    out = {s: (d / ("ref" + s)).read_bytes()
           for s in (".mapping.pam", ".circ_report", ".candidates.pam")}
    assert out[".circ_report"] and out[".mapping.pam"].count(b"\n") == 180
    return d, env, out


CLI_ARGS = ["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq", "-2", "R2.fq",
            "--pam"]


def _cli(args, cwd, env, script=None):
    import subprocess
    import sys
    cmd = [sys.executable] + (["-c", script] if script else []) + args
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


@pytest.mark.parametrize("device", ["native", "gpu-full"])
def test_cli_over_two_contigs_matches_the_reference(cli_dataset, device):
    """The port's CLI with jax and the reference blocked, under
    CIRCMINER_CONTIG_SIZE: PAM, circ_report and candidates.pam byte-equal
    to the reference CLI's --device native (stage 2 sorts on the global
    ordinals the rounds carry in the .ord sidecar)."""
    d, env, want = cli_dataset
    res = _cli(CLI_ARGS + ["-o", device, "--device", device,
                           "--torch-device", "cpu", "--batch-size", "64"],
               d, env, RUN_CLI)
    assert "loaded index: 2 contig(s)" in res.stderr
    for suffix, data in want.items():
        assert (d / (device + suffix)).read_bytes() == data, suffix
