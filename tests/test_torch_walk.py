"""The torch port's multi-exon walk engine (ops/device_walk.py) through its
gpu-full executor, on the three cases of tests/test_device_walk.py: the
Ensembl-density library (walks finish on the device), the budget-starved
engine (walks must defer and replay on the host), and the 12-isoform
library (more common transcripts than the STW = 8 tid lanes must defer).
Every run is held against the native executor on all 20 MatchedRead
fields; on the dense library the per-cause defer histogram must also equal
the JAX pipeline's."""

import numpy as np
import pytest
import torch

from circminer_tpu.pipeline.device_pipeline import \
    DeviceMappingPipeline as JaxPipeline
from circminer_tpu_torch.pipeline.device_pipeline import DeviceMappingPipeline
from test_device_full import FIELDS, make_pairs
from test_device_walk import dense_lib  # noqa: F401  (module fixture)
from test_torch_selfcontained import port_config

BATCH = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(pipe, reads, cfg, statics_patch=None):
    if statics_patch:
        orig = pipe._full_statics
        pipe._full_statics = lambda: {**orig(), **statics_patch}
    pairs = make_pairs(reads, cfg)
    pipe.warmup()
    pipe.map_stream(iter(pairs))
    return [tuple(getattr(p[0].mr, f) for f in FIELDS) for p in pairs]


def _port(db, gi, cfg, reads, statics_patch=None):
    pipe = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=BATCH,
                                 chain_exec="device-full", device="cpu")
    return _run(pipe, reads, cfg, statics_patch), pipe


def _native(db, gi, cfg, reads):
    return _run(DeviceMappingPipeline(db, gi, port_config(cfg),
                                      batch_size=BATCH, chain_exec="native"),
                reads, cfg)


def _assert_parity(got, want):
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not bad, bad[:5]


def test_walk_dense_annotation(dense_lib):
    """Fragmented-interval walks finish on the device, equal to native,
    with the JAX pipeline's defer causes read for read."""
    g, cfg, gi, db, reads = dense_lib
    got, pipe = _port(db, gi, cfg, reads)
    _assert_parity(got, _native(db, gi, cfg, reads))
    ref = JaxPipeline(db, gi, cfg, batch_size=BATCH,
                      chain_exec="device-full")
    _run(ref, reads, cfg)
    fs = pipe.full_stats
    assert (fs["reads"], fs["deferred"]) == (ref.full_stats["reads"],
                                             ref.full_stats["deferred"])
    assert fs["causes"] == ref.full_stats.get("causes", {})
    assert fs["causes"].get("extwalk", 0) <= 0.05 * fs["reads"], fs


def test_walk_budget_starved_defers(dense_lib):
    """One wave of 2-interval scans: the walks it cannot finish defer, and
    the host replay keeps the output equal to native."""
    g, cfg, gi, db, reads = dense_lib
    got, pipe = _port(db, gi, cfg, reads, dict(EW=1, KSCAN=2))
    _assert_parity(got, _native(db, gi, cfg, reads))
    assert pipe.full_stats["causes"].get("extwalk", 0) > 0


def test_walk_many_isoforms_tid_overflow_exact(tmp_path):
    """More common transcripts than the STW = 8 packed tid lanes: those
    pairs defer, never truncate."""
    from circminer_tpu.annotation.annotation import AnnotationDB
    from circminer_tpu.config import Config
    from circminer_tpu.index.build import build_genome_index
    from circminer_tpu.io.fasta import GenomePacker
    from circminer_tpu.sim import make_genome, simulate_reads
    rng = np.random.default_rng(23)
    g = make_genome(rng, length=60_000, n_genes=3, exons_per_gene=6,
                    exon_len=(60, 150), intron_len=(150, 400),
                    n_isoforms=12, bnd_jitter=10)
    ref, gtf = str(tmp_path / "ref.fa"), str(tmp_path / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    contigs, info = GenomePacker(ref).pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, 120, 60, read_len=100,
                              err_rate=0.005)
    got, pipe = _port(db, gi, cfg, reads)
    _assert_parity(got, _native(db, gi, cfg, reads))
    assert pipe.full_stats["reads"] == len(reads)
