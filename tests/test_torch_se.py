"""The torch port's single-end mapping (``map_stream_se``) against the JAX
reference on the CPU.

The world is tests/test_se_mapping.py's (50 kbp, 3 genes of 4 exons,
``Config(kmer=20, max_read_len=300)``) with its batched-parity reads: 30
simulated linear reads, one junk read and one reverse-complemented exon
read.  Each port executor's per-read MatchedRead must equal the reference
``DeviceMappingPipeline.map_stream_se`` field for field (under the same
executor for native and device; under native for the device chain DP,
whose JAX form takes ~50 s to compile and run on the CPU and gives the
native executor's state), and the per-read oracle
``Mapper.process_read_se`` in type, and in position, edit distance and
strand where the read is concordant (what tests/test_se_mapping.py holds
the batched pipeline to).  Batches of 16
reads make the last one partial.  Exact comparisons (tolerance 0)."""

import inspect

import numpy as np
import pytest
import torch

from circminer_tpu.annotation.annotation import AnnotationDB
from circminer_tpu.config import CONCRD, Config
from circminer_tpu.index.build import build_genome_index
from circminer_tpu.io.fasta import GenomePacker
from circminer_tpu.ops import seed as jseed
from circminer_tpu.ops.encode import decode_seq, encode_seq, revcomp
from circminer_tpu.pipeline import mapping as jmapping
from circminer_tpu.pipeline.device_pipeline import \
    DeviceMappingPipeline as JaxPipeline
from circminer_tpu.pipeline.mapping import Mapper
from circminer_tpu.sim import make_genome, simulate_reads
from circminer_tpu_torch.ops import seed_host
from circminer_tpu_torch.pipeline import mapping as tmapping
from circminer_tpu_torch.pipeline.device_pipeline import (
    DeviceMappingPipeline, encode_se)
from test_extend_batch import _key
from test_se_mapping import make_rec
from test_torch_selfcontained import port_config

BATCH = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py maps SE reads there)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("se")
    rng = np.random.default_rng(7)
    g = make_genome(rng, length=50_000, n_genes=3, exons_per_gene=4)
    ref, gtf = str(tmp / "ref.fa"), str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=300)
    contigs, info = GenomePacker(ref).pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                               contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, n_linear=30, n_circ=0)
    seqs = [r.r1 for r in reads]
    seqs.append("".join(rng.choice(list("ACGT"), 100)))  # a junk read
    s, _ = g.genes[0].transcripts[0].exons[0]
    seqs.append(decode_seq(revcomp(encode_seq(g.seq[s - 1:s - 1 + 100]))))
    oracle = [make_rec(cfg, q) for q in seqs]
    mapper = Mapper(db, 0, gi.contigs[0].codes, cfg,
                    tmapping.make_host_seeder(gi.contigs[0], port_config(cfg)))
    for rec in oracle:
        mapper.process_read_se(rec)
    return cfg, gi, db, seqs, [r.mr for r in oracle]


def _map(pipe, cfg, seqs):
    recs = [make_rec(cfg, q) for q in seqs]
    assert pipe.map_stream_se(iter(recs)) == len(seqs)
    return [r.mr for r in recs]


def _concordant_view(mr):
    return (mr.type,) + ((mr.spos_r1, mr.epos_r1, mr.ed_r1, mr.r1_forward)
                         if mr.type == CONCRD else ())


@pytest.mark.parametrize("chain_exec,ref_exec",
                         [("native", "native"), ("device", "device"),
                          ("device-chain", "native"),
                          ("device-full", "native")])
def test_se_matches_jax_pipeline_and_oracle(world, chain_exec, ref_exec):
    cfg, gi, db, seqs, oracle = world
    port = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=BATCH,
                                 chain_exec=chain_exec, device="cpu")
    ref = JaxPipeline(db, gi, cfg, batch_size=BATCH, chain_exec=ref_exec)
    got = _map(port, cfg, seqs)
    want = _map(ref, cfg, seqs)
    bad = [(i, _key(g), _key(w)) for i, (g, w) in enumerate(zip(got, want))
           if _key(g) != _key(w)]
    assert not bad, bad[:3]
    assert [_concordant_view(m) for m in got] == \
        [_concordant_view(m) for m in oracle]
    assert sum(m.type == CONCRD for m in got) >= 25
    assert got[-1].type == CONCRD and not got[-1].r1_forward


def test_se_routing_follows_the_reference():
    """device-full chains single reads on the device after a host lookup;
    device-chain looks up and chains there; device looks up there."""
    calls = []

    class Probe(DeviceMappingPipeline):
        def __init__(self, chain_exec):  # no index: routing only
            self.chain_exec = chain_exec

        def _dispatch_full(self, recs, contig):
            calls.append("full")

        def _chain_device(self, lf):
            calls.append("chain_device")

        def _chain_native(self, lf):
            calls.append("chain_native")

    for ex in ("device-full", "device-chain", "device", "native", "auto"):
        calls.clear()
        Probe(ex).dispatch_chain({"rpr": 2})
        want = "chain_device" if ex in ("device-full", "device-chain") \
            else "chain_native"
        assert calls == [want], ex


def test_encode_se_is_the_reference_layout(world):
    cfg, gi, db, seqs, _ = world
    recs = [make_rec(cfg, q) for q in seqs[:5]]
    ref = JaxPipeline(db, gi, cfg, chain_exec="native")
    want_s, want_l = ref._encode_se(recs)
    got_s, got_l = encode_se(recs, cfg.max_read_len)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_l, want_l)


def _without_lines(fn, drop):
    return [ln for ln in inspect.getsource(fn).splitlines()
            if ln.strip() and ln.strip() not in drop]


def test_host_seeder_is_the_reference_source():
    """The jax-free host seeder of --device host is the reference's code:
    lookup_read_host but for its function-local imports, and the port's
    make_host_seeder (pipeline/mapping.py) but for its import of
    lookup_read_host, which it takes from ops/seed_host.py."""
    assert inspect.getsource(seed_host.SeedHits) == \
        inspect.getsource(jseed.SeedHits)
    imports = {"from .encode import hash_at",
               "from ..utils import logging as ulog",
               "from ..ops.seed import lookup_read_host",
               "from ..ops.seed_host import lookup_read_host"}
    assert _without_lines(seed_host.lookup_read_host, imports) == \
        _without_lines(jseed.lookup_read_host, imports)
    assert _without_lines(tmapping.make_host_seeder, imports) == \
        _without_lines(jmapping.make_host_seeder, imports)


@pytest.mark.cuda
@pytest.mark.parametrize("chain_exec", ["device", "device-chain",
                                        "device-full"])
def test_se_on_card_matches_native(world, chain_exec, cuda_device):
    cfg, gi, db, seqs, _ = world
    port = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=BATCH,
                                 chain_exec=chain_exec, device=cuda_device)
    native = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=BATCH,
                                   chain_exec="native", device="cpu")
    assert [_key(m) for m in _map(port, cfg, seqs)] == \
        [_key(m) for m in _map(native, cfg, seqs)]


def test_se_python_finish_under_trace_matches(world, capfd):
    """-d >= 1 routes the SE finish through the per-read Python path (the
    trace channel), in the port as in the reference: equal state, and the
    oracle's where it is concordant."""
    from circminer_tpu.utils import logging as ulog
    from circminer_tpu_torch.utils import logging as tulog
    cfg, gi, db, seqs, oracle = world
    port = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=BATCH,
                                 chain_exec="device", device="cpu")
    ref = JaxPipeline(db, gi, cfg, batch_size=BATCH, chain_exec="native")
    level = ulog.TRACE_LEVEL
    ulog.set_trace_level(1)      # each package has its own trace channel
    tulog.set_trace_level(1)
    try:
        got, want = _map(port, cfg, seqs), _map(ref, cfg, seqs)
    finally:
        ulog.set_trace_level(level)
        tulog.set_trace_level(level)
    capfd.readouterr()
    assert [_key(m) for m in got] == [_key(m) for m in want]
    assert [_concordant_view(m) for m in got] == \
        [_concordant_view(m) for m in oracle]
