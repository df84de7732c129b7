"""The torch port's alignment DPs (circminer_tpu_torch/ops/pallas_align.py,
ops/align_device.py) against the JAX reference on the CPU.

Every output is an integer, so every comparison is exact (tolerance 0):
the plain torch versions against the JAX scan twins and against the Pallas
kernels in interpret mode, the [B, 10] wave blob against
wave_all_batch_ref, and the wave service against the JAX service request
for request.  The CUDA kernels themselves run only on the card
(``cuda``-marked tests, and chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from circminer_tpu.config import Config
from circminer_tpu.ops import align as al
from circminer_tpu.ops import align_device as jad
from circminer_tpu.ops import pallas_align as jpa
from circminer_tpu_torch.ops import _ext
from circminer_tpu_torch.ops import align_device as tad
from circminer_tpu_torch.ops import pallas_align as tpa
from test_pallas_align import _random_pairs
from test_torch_selfcontained import port_config

W, MAX_ED, MAX_SC = 3, 4, 7
SM = al.ScoreMat()
XD_KW = dict(w=W, mat=SM.mat, mis=SM.mis, ind=SM.ind, xd=SM.xd)
ED_KW = dict(w=W, max_ed=MAX_ED, max_sc=MAX_SC)


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
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs these kernels there)")
    return torch.device("cuda")


def _batch(seed, B=64, reverse=False):
    """Banded-regime pairs (indels, unrelated pairs, N bases) plus a few
    degenerate rows (n or m in 0..w+2), as numpy; reversed in place for the
    left-side kinds."""
    rng = np.random.default_rng(seed)
    s, t, ns, ms = _random_pairs(rng, B)
    for b in range(0, B, 9):
        n, m = int(rng.integers(0, 2 * W + 2)), int(rng.integers(0, W + 3))
        s[b], t[b] = 0, 0
        s[b, :n] = rng.integers(0, 5, size=n)
        t[b, :m] = rng.integers(0, 4, size=m)
        ns[b], ms[b] = n, m
    if reverse:
        for b in range(B):
            s[b, :ns[b]] = s[b, :ns[b]][::-1].copy()
            t[b, :ms[b]] = t[b, :ms[b]][::-1].copy()
    wv = rng.integers(0, W + 1, size=B).astype(np.int32)
    return s, t, ns, ms, wv


def _jx(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _th(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _eq(got, want):
    got = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                    else (want,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32, g.dtype
        np.testing.assert_array_equal(g, np.asarray(w, np.int32))


@pytest.mark.parametrize("reverse", [False, True], ids=["right", "left"])
def test_edit_sc_plain_matches_jax_scan(reverse):
    s, t, n, m, _ = _batch(11, reverse=reverse)
    _eq(tpa.edit_sc_scan(*_th(s, t, n, m), **ED_KW),
        jpa.edit_sc_batch_ref(*_jx(s, t, n, m), **ED_KW))


@pytest.mark.parametrize("reverse", [False, True], ids=["right", "left"])
def test_xdrop_plain_matches_jax_scan(reverse):
    s, t, n, m, _ = _batch(12, reverse=reverse)
    _eq(tpa.xdrop_scan(*_th(s, t, n, m), **XD_KW),
        jpa.xdrop_batch_ref(*_jx(s, t, n, m), **XD_KW))


@pytest.mark.parametrize("reverse", [False, True], ids=["right", "left"])
def test_edit_end_plain_matches_jax_scan(reverse):
    s, t, n, m, _ = _batch(13, reverse=reverse)
    _eq(tad.edit_end_scan(*_th(s, t, n, m), w=W, max_ed=MAX_ED),
        jad.edit_end_batch_ref(*_jx(s, t, n, m), w=W, max_ed=MAX_ED))


def test_one_side_plain_matches_jax_scan():
    s, t, n, m, wv = _batch(14)
    _eq(tad.one_side_scan(*_th(s, t, n, m, wv)),
        jad.one_side_batch_ref(*_jx(s, t, n, m, wv)))


def test_xdrop_plain_matches_pallas_interpret():
    s, t, n, m, _ = _batch(15)
    _eq(tpa.xdrop_scan(*_th(s, t, n, m), **XD_KW),
        jpa.xdrop_batch_pallas(*_jx(s, t, n, m), block_b=64, interpret=True,
                               **XD_KW))


def test_edit_sc_plain_matches_pallas_interpret():
    s, t, n, m, _ = _batch(16)
    _eq(tpa.edit_sc_scan(*_th(s, t, n, m), **ED_KW),
        jpa.edit_sc_batch_pallas(*_jx(s, t, n, m), block_b=64,
                                 interpret=True, **ED_KW))


def test_wave_all_blob_matches_jax():
    s, t, n, m, wv = _batch(17)
    kw = dict(**ED_KW, mat=SM.mat, mis=SM.mis, ind=SM.ind, xd=SM.xd)
    got = tad.wave_all_batch(*_th(s, t, n, m, wv), **kw)
    assert tuple(got.shape) == (64, 10)
    _eq(got, jad.wave_all_batch_ref(*_jx(s, t, n, m, wv), **kw))
    _eq(tad.wave_all_scan(*_th(s, t, n, m, wv), **kw), got)


def test_cpu_wrappers_run_the_plain_versions():
    """On a CPU tensor every wrapper is its plain version and launches no
    kernel (the launch counters stay where they were)."""
    s, t, n, m, wv = _th(*_batch(18))
    before = dict(_ext.LAUNCHES)
    _eq(tpa.xdrop_batch(s, t, n, m, **XD_KW), tpa.xdrop_scan(s, t, n, m,
                                                             **XD_KW))
    _eq(tpa.edit_sc_batch(s, t, n, m, **ED_KW),
        tpa.edit_sc_scan(s, t, n, m, **ED_KW))
    _eq(tad.edit_end_batch(s, t, n, m, w=W, max_ed=MAX_ED),
        tad.edit_end_scan(s, t, n, m, w=W, max_ed=MAX_ED))
    _eq(tad.one_side_batch(s, t, n, m, wv, w=W),
        tad.one_side_scan(s, t, n, m, wv))
    assert _ext.LAUNCHES == before


def _mixed_wave(rng, n_req=260):
    """All seven request kinds, lengths spanning the device regime and the
    host fallback (empty, tiny, > I-1 bases)."""
    kinds = ["edit_sc_r", "edit_sc_l", "drop_sc_r", "drop_sc_l", "end_r",
             "end_l"]
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(0, 131))
        m = int(rng.integers(0, 131))
        s = rng.integers(0, 5, size=n).astype(np.int8)
        if m <= n and rng.random() < 0.7:
            t = s[:m].copy()
            for _ in range(int(rng.integers(0, 4))):
                if m:
                    t[rng.integers(0, m)] = rng.integers(0, 4)
        else:
            t = rng.integers(0, 5, size=m).astype(np.int8)
        reqs.append((kinds[i % len(kinds)], s, t))
        if i % 5 == 0:
            ws = int(rng.integers(-1, 4))
            reqs.append(("one_side", s[:int(rng.integers(0, 40))],
                         t[:int(rng.integers(0, 43))], ws))
    return reqs


def test_service_matches_jax_service_on_mixed_wave():
    cfg = Config(kmer=20, max_read_len=120)
    reqs = _mixed_wave(np.random.default_rng(19))
    port = tad.DeviceAlignService(port_config(cfg), device="cpu")
    ref = jad.DeviceAlignService(cfg)
    got = port.solve_batch(reqs)
    want = ref.solve_batch(reqs)
    assert got == want
    assert (port.n_device, port.n_host, port.n_dispatch) == \
        (ref.n_device, ref.n_host, ref.n_dispatch)
    assert port.n_device > 0 and port.n_host > 0
    kinds = {r[0] for r in reqs}
    assert len(kinds) == 7


@pytest.mark.parametrize("band", [0, 1])
def test_service_sends_one_side_past_the_band_to_the_host(band):
    """The one_side kernel's window is sized from the band: the service warms
    up inside it at every -w (0 included), and a one_side request wider than
    the band goes to the host aligner with the same answer as JAX's."""
    cfg = Config(kmer=20, max_read_len=120, band_width=band)
    port = tad.DeviceAlignService(port_config(cfg), device="cpu")
    port.warm()
    assert (port.n_dispatch, port.n_host) == (1, 0)
    ref = jad.DeviceAlignService(cfg)
    reqs = _mixed_wave(np.random.default_rng(20 + band))
    assert port.solve_batch(reqs) == ref.solve_batch(reqs)
    wide = sum(r[0] == "one_side" and r[3] > band and ref._in_regime(r)
               for r in reqs)
    assert wide > 0
    assert port.n_host == ref.n_host + wide


BATCHES = (1, 33, 1024, 8192)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [0, 1, 2, 3, 5, 8, 31, 127])
def test_kernels_match_plain_on_card(cuda_device, w):
    """Each CUDA kernel bit-equal to its plain version on the card at band
    w (one lane per item up to w = 6, lane groups above) and B in
    BATCHES, and each launch counted."""
    from chip_smoke import kernel_inputs
    xd_kw = dict(XD_KW, w=w)
    ed_kw = dict(ED_KW, w=w)
    _ext.reset_launches()
    for B in BATCHES:
        s, t, n, m, wv = (x.to(cuda_device) for x in _th(*kernel_inputs(
            np.random.default_rng(B + w), B, w)))
        pairs = [
            (tpa.xdrop_batch(s, t, n, m, **xd_kw),
             tpa.xdrop_scan(s, t, n, m, **xd_kw)),
            (tpa.edit_sc_batch(s, t, n, m, **ed_kw),
             tpa.edit_sc_scan(s, t, n, m, **ed_kw)),
            (tad.edit_end_batch(s, t, n, m, w=w, max_ed=MAX_ED),
             tad.edit_end_scan(s, t, n, m, w=w, max_ed=MAX_ED)),
            (tad.one_side_batch(s, t, n, m, wv, w=w),
             tad.one_side_scan(s, t, n, m, wv)),
        ]
        torch.cuda.synchronize()
        for got, want in pairs:
            got = tuple(x.cpu() for x in got) if isinstance(got, tuple) \
                else got.cpu()
            want = tuple(x.cpu() for x in want) if isinstance(want, tuple) \
                else want.cpu()
            _eq(got, want)
    assert all(_ext.LAUNCHES[k] == len(BATCHES) for k in _ext.DP_KERNELS), \
        _ext.LAUNCHES


_TRAP_SCRIPT = """
import numpy as np, torch
from chip_smoke import kernel_inputs
from circminer_tpu_torch.ops import align_device as ad
dev = torch.device("cuda")
s, t, n, m, wv = (torch.from_numpy(x).to(dev) for x in
                  kernel_inputs(np.random.default_rng(5), 256, 3))
ad.one_side_batch(s, t, n, m, wv, w=3)
torch.cuda.synchronize()
print("in-bound launch ok", flush=True)
wv[100] = 4
out = ad.one_side_batch(s, t, n, m, wv, w=3)
torch.cuda.synchronize()
print("answered", out[:4].tolist(), flush=True)
"""


@pytest.mark.cuda
def test_one_side_traps_on_a_row_past_its_bound(cuda_device):
    """A row whose wv exceeds the launch's bound w stops the one_side kernel
    (a trap, which spoils the CUDA context of its process: hence the
    subprocess) rather than return a value that could pass for a result."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _TRAP_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True, timeout=600)
    assert "in-bound launch ok" in res.stdout, res.stderr[-2000:]
    assert res.returncode != 0 and "answered" not in res.stdout, res.stdout
