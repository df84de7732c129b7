"""The torch port's wave-batched mapping slice against the JAX pipeline on
the CPU: the 60 kbp, 4-gene simulation of tests/test_extend_batch.py through
circminer_tpu_torch's DeviceMappingPipeline (device lookup + wave extension,
plain torch versions on the CPU) and through the reference's, MatchedRead
key for key; the device index state array for array; the jax-free host
half of chain.py source for source."""

import inspect

import numpy as np
import pytest
import torch

from circminer_tpu.annotation.annotation import AnnotationDB
from circminer_tpu.config import CATEGORY_NAMES, Config
from circminer_tpu.index.build import build_genome_index
from circminer_tpu.io.fasta import GenomePacker
from circminer_tpu.ops import chain as jchain
from circminer_tpu.pipeline.device_pipeline import \
    DeviceMappingPipeline as JaxPipeline
from circminer_tpu.sim import make_genome, simulate_reads
from circminer_tpu_torch.ops import chain as tchain
from circminer_tpu_torch.pipeline.device_pipeline import (
    ContigDeviceState, DeviceMappingPipeline)
from test_extend_batch import _key, make_rec
from test_torch_selfcontained import port_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: intra-op threads only contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wave")
    rng = np.random.default_rng(23)
    g = make_genome(rng, length=60_000, n_genes=4)
    ref, gtf = str(tmp / "ref.fa"), str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    contigs, info = GenomePacker(ref).pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, 40, 40, err_rate=0.01)
    return cfg, gi, db, reads


def _map(pipe, reads, cfg):
    pairs = [make_rec(r.r1, r.r2, cfg) for r in reads]
    assert pipe.map_stream(iter(pairs)) == len(pairs)
    return [_key(p[0].mr) for p in pairs], [p[0].mr for p in pairs]


def test_wave_slice_matches_jax_pipeline(sim):
    cfg, gi, db, reads = sim
    port = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=64,
                                 chain_exec="device", extend_exec="device",
                                 device="cpu")
    ref = JaxPipeline(db, gi, cfg, batch_size=64, chain_exec="device",
                      extend_exec="device")
    got, mrs = _map(port, reads, cfg)
    want, _ = _map(ref, reads, cfg)
    bad = [(i, CATEGORY_NAMES[mrs[i].type], g, w)
           for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not bad, bad[:3]
    ps, rs = port.align_svc, ref.align_svc
    assert (ps.n_device, ps.n_host, ps.n_dispatch) == \
        (rs.n_device, rs.n_host, rs.n_dispatch)
    assert ps.n_device > 0
    assert port.wave_stats == ref.wave_stats
    assert len({k[0] for k in got}) > 1  # several categories exercised


@pytest.mark.parametrize("chain_exec,extend_exec",
                         [("device", "native"), ("native", "native")])
def test_other_executors_match_jax_native(sim, chain_exec, extend_exec):
    cfg, gi, db, reads = sim
    port = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=32,
                                 chain_exec=chain_exec,
                                 extend_exec=extend_exec, device="cpu")
    ref = JaxPipeline(db, gi, cfg, batch_size=32, chain_exec="native")
    assert _map(port, reads, cfg)[0] == _map(ref, reads, cfg)[0]


def test_contig_device_state_matches_jax(sim):
    cfg, gi, db, _ = sim
    ref = JaxPipeline(db, gi, cfg, chain_exec="device").states[0]
    st = ContigDeviceState.from_contig_index(gi.contigs[0], cfg, "cpu")
    for name in ("entry_hv", "entry_checksum", "entry_pos", "entry_prefix"):
        got, want = getattr(st, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert st.entry_checksum.dtype == torch.int16
    assert (st.prefix_shift, st.prefix_iters) == \
        (ref.prefix_shift, ref.prefix_iters)


@pytest.mark.parametrize("name", ["Chain", "check_junction_host",
                                  "chain_seeds_host", "extract_kbest"])
def test_chain_host_half_is_the_reference_source(name):
    assert inspect.getsource(getattr(tchain, name)) == \
        inspect.getsource(getattr(jchain, name))
    assert (tchain.REWARD_COEF, tchain.PENALTY_COEF) == \
        (jchain.REWARD_COEF, jchain.PENALTY_COEF)


def test_no_silent_fallback_to_cpu(sim):
    """CUDA requested on a host without it raises; unknown executors
    raise."""
    cfg, gi, db, _ = sim
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceMappingPipeline(db, gi, port_config(cfg),
                                  chain_exec="device", device="cuda")
    with pytest.raises(ValueError, match="chain_exec"):
        DeviceMappingPipeline(db, gi, port_config(cfg), chain_exec="tpu",
                              device="cpu")
    with pytest.raises(ValueError, match="device-full"):
        DeviceMappingPipeline(db, gi, port_config(cfg),
                              chain_exec="device-full", extend_exec="device",
                              device="cpu")
    with pytest.raises(ValueError, match="extend_exec"):
        DeviceMappingPipeline(db, gi, port_config(cfg), extend_exec="auto",
                              device="cpu")
