"""The port's multi-device steps (``circminer_tpu_torch/parallel/mesh.py``)
on the CPU: two gloo ranks, one process each (``graft_entry.run_ranks``),
against the port's single-process steps and the JAX mesh functions on a
2-device virtual CPU mesh (conftest), on the reference dry run's tiny
problem (``__graft_entry__._tiny_problem``).

Every output is an integer array, so every comparison is exact.  The
ranks run once per file; each JAX sharded full step compiles once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from circminer_tpu.config import CHIBSJ, CHI2BSJ
from circminer_tpu.ops import seed as jseed
from circminer_tpu.parallel import mesh as jmesh
from circminer_tpu_torch import graft_entry as tentry
from circminer_tpu_torch.ops import seed as tseed
from circminer_tpu_torch.parallel import mesh as tmesh
from circminer_tpu_torch.pipeline.circ import ProcessCirc
from circminer_tpu_torch.pipeline.device_pipeline import DeviceMappingPipeline
from test_device_full import make_pairs
from test_multichip_e2e import _world
from test_torch_selfcontained import port_config

D = 2          # ranks, and devices of the JAX mesh
CAP = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    return tentry.mesh_problem(D)


@pytest.fixture(scope="module")
def ref_problem():
    return jentry._tiny_problem(D)


def test_tiny_problem_is_the_reference_one(problem, ref_problem):
    cfg, ci, ad, reads, lens, _ = ref_problem
    assert dataclasses.astuple(problem["cfg"]) == dataclasses.astuple(cfg)
    for name in ("codes", "entry_hv", "entry_checksum", "entry_pos"):
        np.testing.assert_array_equal(getattr(problem["ci"], name),
                                      getattr(ci, name))
    np.testing.assert_array_equal(problem["reads"], np.asarray(reads))
    np.testing.assert_array_equal(problem["lens"], np.asarray(lens))
    for f in dataclasses.fields(problem["ad"]):
        got = getattr(problem["ad"], f.name)
        want = getattr(ad, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            assert got == want, f.name


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_shard_index_arrays_equal_the_reference(ref_problem, n_shards):
    cfg, ci = ref_problem[0], ref_problem[1]
    got = tmesh.shard_index_arrays(ci, n_shards, window_size=cfg.window_size)
    want = jmesh.shard_index_arrays(ci, n_shards,
                                    window_size=cfg.window_size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sharded_local_lookup_sums_to_the_single_lookup(problem):
    """Owner-computes masking: the shards' contributions sum to the port's
    lookup_batch_device + gather over the whole table, and each shard's
    contribution equals JAX's lookup_gather_sharded_local."""
    cfg, ci = problem["cfg"], problem["ci"]
    reads = torch.from_numpy(problem["reads"])
    lens = torch.from_numpy(problem["lens"])
    kw = dict(k=cfg.kmer, cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
              seed_lim=cfg.seed_lim)
    qpos_d, start_d, cnt_d, high_d = tseed.lookup_batch_device(
        reads, lens, torch.from_numpy(ci.entry_hv),
        torch.from_numpy(ci.entry_checksum), **kw)
    want_pos, _ = tseed.gather_seeds_device(
        torch.from_numpy(ci.entry_pos), start_d[:, ::2], cnt_d[:, ::2],
        cap=CAP)
    n = 4
    arrs = tmesh.shard_index_arrays(ci, n, window_size=cfg.window_size)
    sums = [0, 0, 0]
    for d in range(n):
        lhv, lcs, lpos, blo, bhi = (a[d] for a in arrs)
        got = tseed.lookup_gather_sharded_local(
            reads, lens, torch.from_numpy(lhv), torch.from_numpy(lcs),
            torch.from_numpy(lpos), torch.tensor(blo), torch.tensor(bhi),
            cap=CAP, **kw)
        want = jseed.lookup_gather_sharded_local(
            jnp.asarray(problem["reads"]), jnp.asarray(problem["lens"]),
            jnp.asarray(lhv), jnp.asarray(lcs), jnp.asarray(lpos),
            jnp.int32(blo), jnp.int32(bhi), cap=CAP, **kw)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got[0].numpy(),
                                      qpos_d[:, ::2].numpy())
        sums = [s + t for s, t in zip(sums, got[1:])]
    np.testing.assert_array_equal(sums[0].numpy(), want_pos.numpy())
    np.testing.assert_array_equal(sums[1].numpy(), cnt_d[:, ::2].numpy())
    np.testing.assert_array_equal(sums[2].numpy(),
                                  high_d[:, ::2].to(torch.int32).numpy())
    assert int(sums[1].sum()) > 0


@pytest.fixture(scope="module")
def bsj_world(tmp_path_factory):
    """tests/test_multichip_e2e.py's world mapped by the port's native
    executor: its pairs, and the BSJ candidates (genome_spos, global pair
    index) in D per-rank [CAP, 2] blocks, sentinel padded; rank d holds
    pairs d, d + D, ... (the multi-host stripe)."""
    cfg, gi, db, reads = _world(tmp_path_factory.mktemp("mesh_e2e"))
    pairs = make_pairs(reads, cfg)
    pipe = DeviceMappingPipeline(db, gi, port_config(cfg), batch_size=32,
                                 chain_exec="native")
    pipe.map_stream(iter(pairs))
    per = -(-len(pairs) // D)
    cand = np.full((D, per, 2), 2 ** 30, np.int32)
    cnt = np.zeros(D, np.int32)
    for i, pr in enumerate(pairs):
        if pr[0].mr.type in (CHIBSJ, CHI2BSJ):
            pr[0].mr.genome_spos = pr[0].mr.spos_r1
            d = i % D
            cand[d, cnt[d]] = (pr[0].mr.genome_spos, i)
            cnt[d] += 1
    assert cnt.sum() > 0 and (cnt > 0).all()
    return cfg, gi, db, pairs, cand.reshape(D * per, 2), cnt


@pytest.fixture(scope="module")
def ranks(problem, bsj_world):
    """Every sharded step on two gloo ranks (one process each)."""
    p = dict(problem, cand=bsj_world[4], cand_count=bsj_world[5])
    return tentry.run_ranks(D, p, backend="gloo", device="cpu",
                            timeout=400)


@pytest.fixture(scope="module")
def single(problem):
    return tentry.single_outputs(problem, "cpu")


@pytest.fixture(scope="module")
def jax_mesh(ref_problem, problem):
    """The JAX mesh functions on a 2-device mesh over the same inputs."""
    assert len(jax.devices()) >= D, "virtual mesh missing"
    cfg, ci, ad, reads, lens, _ = ref_problem
    mesh = jmesh.make_mesh(D)
    rep = lambda a: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jmesh.replicate(mesh, x), a)
    anno = [rep(a) for a in (ad.nb_bits, ad.iv_spos, ad.iv_epos,
                             ad.iv_max_end, ad.iv_min_end, ad.iv_max_next,
                             ad.iv_nseg, ad.seg_end, ad.seg_next)]
    kw = dict(k=cfg.kmer, cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
              seed_lim=cfg.seed_lim, seg_pad=ad.seg_pad, seed_cap=CAP)
    idx = [jnp.asarray(ci.entry_hv), jnp.asarray(ci.entry_checksum),
           jnp.asarray(ci.entry_pos)]
    out = {}
    step = jmesh.make_sharded_map_step(mesh, cfg, **kw)
    res = step(jmesh.shard_reads(mesh, reads), jmesh.shard_reads(mesh, lens),
               *[rep(a) for a in idx], *anno)
    out["map"] = tuple(np.asarray(a) for a in res[:4]) + (int(res[4]),)
    step = jmesh.make_index_sharded_map_step(
        mesh, cfg, shard_batch=reads.shape[0] // D, **kw)
    out["index_map"] = tuple(np.asarray(a) for a in step(
        jmesh.shard_reads(mesh, reads), jmesh.shard_reads(mesh, lens),
        *jmesh.shard_index(mesh, ci, window_size=cfg.window_size), *anno))
    # the full steps take the port problem's inputs and statics
    from circminer_tpu.annotation.device import FinishAnnoDevice
    fa = FinishAnnoDevice.from_contig(ref_problem[5].contigs[0],
                                      ref_problem[5].con2chr[0], seg_pad=4)
    st = problem["statics"]
    rows = [jmesh.shard_reads(mesh, jnp.asarray(problem[k]))
            for k in ("seqs4", "lens4", "mr_in")]
    genome, fad, add = (rep(a) for a in (jnp.asarray(ci.codes), fa, ad))
    step = jmesh.make_sharded_full_step(mesh, st, contig_num=0)
    out["full"] = np.asarray(step(*rows, *[rep(a) for a in idx], genome, add,
                                  fad, None))
    step = jmesh.make_index_sharded_full_step(
        mesh, st, shard_batch=problem["mr_in"].shape[0] // D, contig_num=0)
    out["index_full"] = np.asarray(step(
        *rows, *jmesh.shard_index(mesh, ci, window_size=cfg.window_size),
        genome, add, fad))
    return out


STEP_NAMES = ["map", "index_map", "full", "index_full"]


def _assert_outputs(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, int):
            assert g == w, (what, i)
            continue
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("step", STEP_NAMES)
def test_sharded_step_equals_the_single_process_step(ranks, single, problem,
                                                     step):
    want = single["full"] if step == "index_full" else single[step]
    _assert_outputs(ranks[step], want, step)
    if step in ("full", "index_full"):   # real (non-default) state somewhere
        assert (ranks[step][:, 0] != problem["mr_in"][:, 0]).any()


@pytest.mark.parametrize("step", STEP_NAMES)
def test_sharded_step_equals_the_jax_mesh_function(ranks, jax_mesh, step):
    _assert_outputs(ranks[step], jax_mesh[step], step)


def test_merge_bsj_candidates_equals_jax_and_orders_the_report(
        ranks, bsj_world, tmp_path):
    """The gathered candidates equal JAX's all-gather of the same blocks,
    and host 0's (genome_spos, global index) order gives the single-run
    circ_report (tests/test_multichip_e2e.py)."""
    cfg, gi, db, pairs, cand, cnt = bsj_world
    mesh = jmesh.make_mesh(D)
    cg_j, ng_j = jmesh.merge_bsj_candidates(
        mesh, jmesh.shard_reads(mesh, jnp.asarray(cand)),
        jmesh.shard_reads(mesh, jnp.asarray(cnt)))
    cg, ng = ranks["merge"]
    assert cg.shape == (D, cand.shape[0] // D, 2) and ng.shape == (D,)
    np.testing.assert_array_equal(cg, np.asarray(cg_j))
    np.testing.assert_array_equal(ng, np.asarray(ng_j).reshape(-1))

    def report(ordered, name):
        pc = ProcessCirc(db, gi, port_config(cfg), str(tmp_path / name),
                         device="cpu")
        pc.run(ordered)
        pc.report_events(str(tmp_path / name) + ".circ_report")
        return (tmp_path / (name + ".circ_report")).read_bytes()

    real = cg.reshape(-1, 2)
    real = real[real[:, 0] != 2 ** 30]
    order = real[np.lexsort((real[:, 1], real[:, 0]))]
    got = report([pairs[int(i)] for _, i in order], "merged")
    bsj = [(i, pr) for i, pr in enumerate(pairs)
           if pr[0].mr.type in (CHIBSJ, CHI2BSJ)]
    bsj.sort(key=lambda t: (t[1][0].mr.genome_spos, t[0]))
    want = report([pr for _, pr in bsj], "single")
    assert got == want and len(want) > 0


def test_collectives_of_a_world_of_one_are_identities():
    mesh = tmesh.make_mesh(1, device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.backend) == \
        (None, 0, 1, None)
    t = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    assert tmesh.psum(mesh, t) is t
    assert torch.equal(tmesh.gather_rows(mesh, t), t)
    assert torch.equal(tmesh.all_gather(mesh, t, tiled=False), t[None])
    assert torch.equal(tmesh.shard_reads(mesh, t.numpy()), t)
    with pytest.raises(TypeError, match="int32"):
        tmesh.psum(mesh, t.to(torch.int64))
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tmesh.init_group("mpi", "tcp://127.0.0.1:1", 1, 0)


def test_nccl_is_refused_without_a_device_per_rank(monkeypatch):
    """A NCCL request that cannot be met raises; it never becomes gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        tmesh.init_group("nccl", "tcp://127.0.0.1:1", 1, 0)
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_graft_entry_dry_run_on_two_gloo_ranks(capsys):
    tentry.dryrun_multichip(D, device="cpu", timeout=400)
    assert "dryrun_multichip(2): ok on gloo" in capsys.readouterr().out
    fn, args = tentry.entry("cpu")
    dp10, back = fn(*args)
    assert dp10.shape == back.shape == (16, 6, CAP)
