"""The torch port's ``auto`` executor: ``CIRCMINER_EXECUTOR``, the decision
cache and the probe (``DeviceMappingPipeline.warmup``), on the CPU.

The world is tests/test_torch_wave.py's (60 kbp, 4 genes, 40 linear + 40
circular pairs).  Whatever ``auto`` picks, its mapping must equal the
native executor's and the JAX reference's ``auto`` pipeline, MatchedRead
key for key (exact)."""

import json
import os

import numpy as np
import pytest
import torch

from circminer_tpu.annotation.annotation import AnnotationDB
from circminer_tpu.config import Config
from circminer_tpu.index.build import build_genome_index
from circminer_tpu.io.fasta import GenomePacker
from circminer_tpu.pipeline.device_pipeline import \
    DeviceMappingPipeline as JaxPipeline
from circminer_tpu.sim import make_genome, simulate_reads
from circminer_tpu_torch.pipeline.device_pipeline import DeviceMappingPipeline
from test_extend_batch import _key, make_rec
from test_torch_selfcontained import port_config

BATCH = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    """Every test gets its own decision cache and no forced executor."""
    monkeypatch.setenv("CIRCMINER_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("CIRCMINER_EXECUTOR", raising=False)
    return tmp_path / "cache"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py probes there)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("auto")
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


def _auto(sim, device="cpu"):
    cfg, gi, db, _ = sim
    return DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=BATCH,
                                 chain_exec="auto", device=device)


def _map(pipe, sim):
    cfg, _, _, reads = sim
    pairs = [make_rec(r.r1, r.r2, cfg) for r in reads]
    assert pipe.map_stream(iter(pairs)) == len(pairs)
    return [_key(p[0].mr) for p in pairs]


@pytest.mark.parametrize("forced", ["device", "native"])
def test_env_forces_the_choice(sim, monkeypatch, capfd, forced):
    monkeypatch.setenv("CIRCMINER_EXECUTOR", forced)
    pipe = _auto(sim)
    pipe.warmup()
    assert pipe.chain_exec == forced
    assert f"auto executor: {forced} (from env)" in capfd.readouterr().err
    native = DeviceMappingPipeline(sim[2], sim[1], sim[0], batch_size=BATCH,
                                   chain_exec="native")
    assert _map(pipe, sim) == _map(native, sim)


def test_env_refuses_an_unknown_executor(sim, monkeypatch):
    monkeypatch.setenv("CIRCMINER_EXECUTOR", "device-full")
    with pytest.raises(ValueError, match="CIRCMINER_EXECUTOR"):
        _auto(sim).warmup()


def test_decision_cache_round_trip(sim, _cache_dir, capfd):
    pipe = _auto(sim)
    path, key = pipe._decision_cache_path()
    assert os.path.dirname(path) == str(_cache_dir)
    assert key.split("|")[1:] == ["cpu", "cpu", str(BATCH),
                                  str(sim[0].n_kmer_lists)]
    assert pipe._cached_decision() is None
    pipe._store_decision("native", {"host_ms": 1.0})
    with open(path) as f:
        assert json.load(f) == {"key": key, "executor": "native",
                                "host_ms": 1.0}
    assert pipe._cached_decision() == "native"
    again = _auto(sim)
    again.warmup()
    assert again.chain_exec == "native"
    assert "auto executor: native (from cache)" in capfd.readouterr().err
    # a record made for another host, card, batch or read length is ignored
    with open(path, "w") as f:
        json.dump({"key": key + "x", "executor": "native"}, f)
    assert pipe._cached_decision() is None
    with open(path, "w") as f:
        f.write("not json")
    assert pipe._cached_decision() is None


def test_probe_on_cpu_decides_and_stores_nothing(sim, _cache_dir, capfd):
    pipe = _auto(sim)
    pipe.warmup()
    assert pipe.chain_exec in ("device", "native")
    err = capfd.readouterr().err
    assert "auto executor: d2h" in err and f"-> {pipe.chain_exec}" in err
    assert not _cache_dir.exists()


def test_auto_map_equals_native_and_jax_auto(sim, monkeypatch):
    cfg, gi, db, _ = sim
    pipe = _auto(sim)
    pipe.warmup()
    native = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=BATCH,
                                   chain_exec="native")
    got = _map(pipe, sim)
    assert got == _map(native, sim)
    # the reference's auto, forced to the same choice (its own probe would
    # time the JAX CPU backend instead)
    monkeypatch.setenv("CIRCMINER_EXECUTOR", pipe.chain_exec)
    ref = JaxPipeline(db, gi, cfg, batch_size=BATCH, chain_exec="auto")
    ref.warmup()
    assert ref.chain_exec == pipe.chain_exec
    assert got == _map(ref, sim)


@pytest.mark.cuda
def test_probe_on_card_is_cached(sim, _cache_dir, cuda_device, capfd):
    pipe = _auto(sim, cuda_device)
    pipe.warmup()
    path, key = pipe._decision_cache_path()
    assert key.split("|")[1:3] == ["cuda",
                                   torch.cuda.get_device_name(cuda_device)]
    with open(path) as f:
        rec = json.load(f)
    assert rec["executor"] == pipe.chain_exec
    assert {"d2h_bw_mbps", "d2h_lat_ms", "est_device_ms", "host_ms"} <= \
        set(rec)
    again = _auto(sim, cuda_device)
    again.warmup()
    assert again.chain_exec == pipe.chain_exec
    assert "(from cache)" in capfd.readouterr().err
