"""The torch port's device seed lookup (circminer_tpu_torch/ops/seed.py)
against the JAX lookup and the host C++ NativeSeeder on the CPU; exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from circminer_tpu.config import Config
from circminer_tpu.index.build import build_contig_index
from circminer_tpu.ops import seed as jseed
from circminer_tpu.ops.seed_native import NativeSeeder
from circminer_tpu_torch.ops import seed as tseed
from circminer_tpu_torch.pipeline.device_pipeline import (ContigDeviceState,
                                                          lookup_even)
from test_torch_selfcontained import port_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: intra-op threads only contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the lookup there)")
    return torch.device("cuda")


def _genome(rng, n, n_frac=0.01):
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    codes[rng.random(n) < n_frac] = 4
    return codes


def _reads(rng, codes, B, L, lo):
    """Exact genome substrings (so lookups hit), some with an N, some
    short, plus a few random reads."""
    reads = np.zeros((B, L), np.int8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(lo, L + 1))
        st = int(rng.integers(0, len(codes) - ln))
        reads[b, :ln] = codes[st:st + ln] if b % 7 else \
            rng.integers(0, 4, size=ln)
        if rng.random() < 0.3:
            reads[b, rng.integers(0, ln)] = 4
        lens[b] = ln
    return reads, lens


@pytest.fixture(scope="module")
def small():
    """kmer 8 / window 6 index over 5 kbp with repeats, as
    tests/test_encode_index.py builds it."""
    rng = np.random.default_rng(31)
    cfg = Config(kmer=8, window_size=6, max_read_len=40, seed_lim=1)
    codes = _genome(rng, 5000)
    codes[3000:3400] = codes[1000:1400]          # a repeat for multi-hits
    ci = build_contig_index(codes, "1", cfg)
    reads, lens = _reads(rng, codes, 32, 40, 12)
    return cfg, ci, reads, lens


@pytest.mark.parametrize("with_prefix", [False, True],
                         ids=["full_bisect", "radix_prefix"])
def test_lookup_matches_jax(small, with_prefix):
    cfg, ci, reads, lens = small
    kw = dict(k=cfg.kmer, cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
              seed_lim=cfg.seed_lim)
    pref = None
    if with_prefix:
        pref, shift, iters = jseed.build_device_prefix(ci.entry_hv,
                                                       cfg.window_size)
        kw.update(prefix_shift=shift, prefix_iters=iters)
    want = jseed.lookup_batch_device(
        jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(ci.entry_hv),
        jnp.asarray(ci.entry_checksum),
        jnp.asarray(pref) if pref is not None else None, **kw)
    got = tseed.lookup_batch_device(
        torch.from_numpy(reads), torch.from_numpy(lens),
        torch.from_numpy(ci.entry_hv), torch.from_numpy(ci.entry_checksum),
        torch.from_numpy(pref) if pref is not None else None, **kw)
    assert len(got) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[2].sum()) > 0 and bool(got[3].any())  # hits + high hits


def test_build_device_prefix_matches_original():
    rng = np.random.default_rng(32)
    for n, window in ((0, 14), (1, 14), (1000, 6), (50_000, 14), (3000, 3)):
        hv = np.sort(rng.integers(0, 4 ** window, size=n)).astype(np.int32)
        got = tseed.build_device_prefix(hv, window)
        want = jseed.build_device_prefix(hv, window)
        assert got[1:] == want[1:]
        if want[0] is None:
            assert got[0] is None
        else:
            assert got[0].dtype == want[0].dtype
            np.testing.assert_array_equal(got[0], want[0])


def test_lookup_even_matches_native_seeder():
    """The pipeline's device lookup layout (start | cnt | high count) at the
    production k = 20 against the host C++ lookup it replaces."""
    rng = np.random.default_rng(33)
    cfg = Config(kmer=20, max_read_len=120)
    codes = _genome(rng, 40_000, n_frac=0.002)
    codes[20_000:22_000] = codes[5_000:7_000]
    ci = build_contig_index(codes, "1", cfg)
    reads, lens = _reads(rng, codes, 48, 120, 30)
    st = ContigDeviceState.from_contig_index(ci, port_config(cfg), "cpu")
    packed = lookup_even(torch.from_numpy(reads), torch.from_numpy(lens), st,
                         port_config(cfg)).numpy()
    _, start, cnt, high = NativeSeeder(ci, cfg).lookup(reads, lens)
    NL = cfg.n_kmer_lists
    np.testing.assert_array_equal(packed[:, :NL], start)
    np.testing.assert_array_equal(packed[:, NL:2 * NL], cnt)
    np.testing.assert_array_equal(packed[:, 2 * NL], high)
    assert int(cnt.sum()) > 0


@pytest.mark.cuda
def test_lookup_on_card_matches_cpu(small, cuda_device):
    cfg, ci, reads, lens = small
    outs = []
    for dev in ("cpu", cuda_device):
        st = ContigDeviceState.from_contig_index(ci, port_config(cfg), dev)
        outs.append(lookup_even(torch.from_numpy(reads).to(dev),
                                torch.from_numpy(lens).to(dev), st,
                                port_config(cfg)).cpu().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
