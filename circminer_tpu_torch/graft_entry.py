"""Entry points of the port: a single-device compile-and-run check of the
mapping step and a multi-process dry run of every sharded step.

Counterpart of the repository's root ``__graft_entry__.py``, which belongs
to the JAX reference.  One process per rank (``parallel/mesh.py``):

    python -m circminer_tpu_torch.graft_entry                  # on the card
    python -m circminer_tpu_torch.graft_entry --device cpu --ranks 2

``run_ranks`` starts the ranks as subprocesses of this module (each joins
one process group through ``mesh.init_group``, runs ``sharded_outputs`` on
a problem the parent saved, and rank 0 writes the gathered outputs back);
every rank runs under a timeout and checks that it loaded neither jax nor
the reference package.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .device import resolve_device

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("map", "index_map", "full", "index_full", "merge")


def _tiny_problem(n_devices: int = 1, device="cuda"):
    """Deterministic tiny genome/index/annotation + read batch (the
    reference's ``_tiny_problem``): (cfg, ci, ad, reads [B, L] int8, lens
    [B] int32, db), tensors on ``device``."""
    from .annotation.annotation import AnnotationDB
    from .annotation.device import AnnoDevice
    from .config import Config
    from .index.build import build_contig_index
    from .io.fasta import ContigLen

    dev = resolve_device(device)
    cfg = Config(kmer=12, window_size=8, max_read_len=64, seed_lim=32)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=20_000).astype(np.int8)
    ci = build_contig_index(codes, "1", cfg)

    gtf = ("chr1\tx\tgene\t1000\t5000\t.\t+\t.\tgene_id \"G1\";\n"
           "chr1\tx\ttranscript\t1000\t5000\t.\t+\t.\t"
           "gene_id \"G1\"; transcript_id \"T1\";\n"
           "chr1\tx\texon\t1000\t2000\t.\t+\t.\t"
           "gene_id \"G1\"; transcript_id \"T1\"; exon_number \"1\";\n"
           "chr1\tx\texon\t3000\t5000\t.\t+\t.\t"
           "gene_id \"G1\"; transcript_id \"T1\"; exon_number \"2\";\n")
    with tempfile.NamedTemporaryFile("w", suffix=".gtf", delete=False) as f:
        f.write(gtf)
        gtf_path = f.name
    try:
        db = AnnotationDB.from_gtf(gtf_path,
                                   [ContigLen("chr1", 1, 0, 20_000)], 1, cfg,
                                   contig_lengths=[20_000])
    finally:
        os.unlink(gtf_path)
    ad = AnnoDevice.from_contig(db.contigs[0], seg_pad=4, device=dev)

    B = 16 * max(1, n_devices)
    L = cfg.max_read_len
    reads = np.zeros((B, L), dtype=np.int8)
    lens = np.full(B, L, dtype=np.int32)
    for b in range(B):
        s = int(rng.integers(0, len(codes) - L))
        reads[b] = codes[s:s + L]
    return (cfg, ci, ad, torch.from_numpy(reads).to(dev),
            torch.from_numpy(lens).to(dev), db)


def _anno_args(ad):
    return (ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end, ad.iv_min_end,
            ad.iv_max_next, ad.iv_nseg, ad.seg_end, ad.seg_next)


def _one_device_map_step(cfg, seg_pad: int, cap: int, device):
    """The mapping step (lookup -> gather -> dense chain DP) on one device:
    the sharded map step over a world of one."""
    from .parallel.mesh import Mesh, make_sharded_map_step
    return make_sharded_map_step(
        Mesh(None, 0, 1, resolve_device(device)), cfg, k=cfg.kmer,
        cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
        seed_lim=cfg.seed_lim, seg_pad=seg_pad, seed_cap=cap)


def entry(device="cuda"):
    """(fn, example_args): the mapping step on one device, its arguments
    on ``device``; fn returns (dp10, back)."""
    cfg, ci, ad, reads, lens, _db = _tiny_problem(1, device)
    step = _one_device_map_step(cfg, ad.seg_pad, 16, device)

    def fn(*args):
        return step(*args)[:2]

    def put(a):
        return torch.from_numpy(a).to(reads.device)
    example_args = (reads, lens, put(ci.entry_hv), put(ci.entry_checksum),
                    put(ci.entry_pos), *_anno_args(ad))
    return fn, example_args


def mesh_problem(n_devices: int) -> dict:
    """The dry run's problem for an ``n_devices`` mesh, on the CPU: the
    tiny problem's reads for the map steps, 4 rows per pair (r1, rc(r1),
    r2, rc(r2)) with the default MatchedRead state for the full steps,
    and the reference dry run's statics (``sharded_outputs``' keys)."""
    from .annotation.device import FinishAnnoDevice
    from .ops.align import ScoreMat
    from .ops.encode import revcomp
    from .ops.filter_native import NativeFilter
    from .pipeline.types import MatchedRead

    cfg, ci, ad, reads, lens, db = _tiny_problem(n_devices, "cpu")
    fa = FinishAnnoDevice.from_contig(db.contigs[0], db.con2chr[0],
                                      seg_pad=4, device="cpu")
    B, L = reads.shape
    n_pairs = (B // 2 // n_devices) * n_devices or n_devices
    seqs4 = np.zeros((4 * n_pairs, L), np.int8)
    lens4 = np.zeros(4 * n_pairs, np.int32)
    reads_h = reads.numpy()
    for i in range(n_pairs):
        r1 = reads_h[(2 * i) % B]
        r2 = reads_h[(2 * i + 1) % B]
        for o, s in enumerate((r1, revcomp(r1), r2, revcomp(r2))):
            seqs4[4 * i + o, :len(s)] = s
            lens4[4 * i + o] = len(s)
    default_row = NativeFilter.mr_to_state(MatchedRead.default(cfg.max_ed),
                                           ["chr1"])
    mr_in = np.ascontiguousarray(
        np.tile(default_row, (n_pairs, 1)).astype(np.int32))
    sm = ScoreMat()
    statics = dict(
        k=cfg.kmer, cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
        seed_lim=cfg.seed_lim, cap=16, max_ed=cfg.max_ed,
        max_sc=cfg.max_sc, band=cfg.band_width, max_tlen=cfg.max_tlen,
        max_intron=cfg.max_intron, seg_pad=4, scan_level=cfg.scan_level,
        KB=6, P_MAX=8, W_MAX=16, OS_POOL=256, XD_POOL=512, EX_ITERS=48,
        mat=sm.mat, mis=sm.mis, ind=sm.ind, xd=sm.xd)
    return dict(cfg=cfg, ci=ci, ad=ad, fa=fa, reads=reads_h,
                lens=lens.numpy(), seqs4=seqs4, lens4=lens4, mr_in=mr_in,
                statics=statics, seed_cap=16, prefix=None, prefix_shift=0,
                prefix_iters=0, contig_num=0, steps=STEPS)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, fn):
    """(result, ms): fn() timed by CUDA events on a CUDA device, by the
    host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def sharded_outputs(mesh, p: dict) -> dict:
    """Run each step of ``p["steps"]`` (``STEPS``) of ``parallel/mesh.py``
    on this rank's rows of problem ``p`` (``mesh_problem``'s keys; ``cand``
    [D * cap, 2] and ``cand_count`` [D] give the merge its candidates, else
    it carries (first seed position, +100) of each map row) and return the
    gathered outputs as numpy arrays, with each step's ms."""
    from .parallel import mesh as pm
    cfg, ci, st = p["cfg"], p["ci"], p["statics"]
    dev = mesh.device
    steps = p["steps"]
    rep = {name: pm.replicate(mesh, getattr(ci, name)) for name in
           ("entry_hv", "entry_checksum", "entry_pos", "codes")}
    ad, fa = pm.replicate(mesh, p["ad"]), pm.replicate(mesh, p["fa"])
    anno = _anno_args(ad)
    index_sh = (pm.shard_index(mesh, ci, window_size=cfg.window_size)
                if {"index_map", "index_full"} & set(steps) else None)
    out = dict(ms={}, backend=mesh.backend, size=mesh.size)

    def run(name, fn):
        res, out["ms"][name] = _timed(dev, fn)
        return res

    def host(*ts):
        return tuple(pm.gather_rows(mesh, t).cpu().numpy() for t in ts)

    kw = dict(k=cfg.kmer, cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
              seed_lim=cfg.seed_lim, seg_pad=st["seg_pad"],
              seed_cap=p["seed_cap"])
    if {"map", "index_map"} & set(steps):
        reads, lens = (pm.shard_reads(mesh, p[key]) for key in
                       ("reads", "lens"))
    if "map" in steps:
        step = pm.make_sharded_map_step(mesh, cfg, **kw)
        dp10, back, pos_b, hh, total = run("map", lambda: step(
            reads, lens, rep["entry_hv"], rep["entry_checksum"],
            rep["entry_pos"], *anno))
        out["map"] = host(dp10, back, pos_b, hh) + (int(total),)
    if "index_map" in steps:
        step = pm.make_index_sharded_map_step(
            mesh, cfg, shard_batch=reads.shape[0], **kw)
        out["index_map"] = host(*run("index_map", lambda: step(
            reads, lens, *index_sh, *anno)))
    seqs, lens4, mr_in = (pm.shard_reads(mesh, p[key]) for key in
                          ("seqs4", "lens4", "mr_in"))
    if "full" in steps:
        step = pm.make_sharded_full_step(
            mesh, st, contig_num=p["contig_num"],
            prefix_shift=p["prefix_shift"], prefix_iters=p["prefix_iters"])
        prefix = pm.replicate(mesh, p["prefix"])
        out["full"], = host(run("full", lambda: step(
            seqs, lens4, mr_in, rep["entry_hv"], rep["entry_checksum"],
            rep["entry_pos"], rep["codes"], ad, fa, prefix)))
    if "index_full" in steps:
        step = pm.make_index_sharded_full_step(
            mesh, st, shard_batch=mr_in.shape[0], contig_num=p["contig_num"])
        out["index_full"], = host(run("index_full", lambda: step(
            seqs, lens4, mr_in, *index_sh, rep["codes"], ad, fa)))
    if "merge" in steps:
        if p.get("cand") is not None:
            cand = pm.shard_reads(mesh, p["cand"])
            count = pm.shard_reads(mesh, p["cand_count"])
        else:
            first = pos_b[:, 0, 0]
            cand = torch.stack([first, first + 100], dim=1)
            count = torch.tensor([cand.shape[0]], dtype=torch.int32,
                                 device=dev)
        cg, ng = run("merge", lambda: pm.merge_bsj_candidates(mesh, cand,
                                                               count))
        out["merge"] = (cg.cpu().numpy(), ng.cpu().numpy())
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n_ranks: int, problem: dict, *, backend: str = "gloo",
              device="cuda", timeout: float = 600.0) -> dict:
    """Run ``sharded_outputs`` on ``problem`` in ``n_ranks`` processes of
    one ``backend`` process group, each under ``timeout`` seconds, and
    return rank 0's result (the gathered outputs are the same on every
    rank).  Ranks on "cuda" take ``cuda:rank % device_count``."""
    env = dict(os.environ, PYTHONPATH=_PKG_PARENT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory(prefix="circminer_ranks_") as tmp:
        payload = os.path.join(tmp, "problem.pt")
        torch.save(problem, payload)
        init = f"tcp://127.0.0.1:{_free_port()}"
        procs, logs = [], []
        for r in range(n_ranks):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "circminer_tpu_torch.graft_entry",
                 "--rank", str(r), "--ranks", str(n_ranks), "--init", init,
                 "--backend", backend, "--device", str(device),
                 "--payload", payload, "--out", tmp],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            hung = [r for r, p in enumerate(procs) if p.poll() is None]
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            tails.append(f"rank {r}: " + log.read()[-3000:])
            log.close()
        if hung:
            raise RuntimeError(f"ranks {hung} ran past {timeout} s:\n"
                               + "\n".join(tails))
        if failed:
            raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(tails))
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)


def _rank_main(args) -> int:
    """One rank of ``run_ranks``."""
    from .parallel import mesh as pm
    device = args.device
    if device == "cpu":
        torch.set_num_threads(1)
    elif args.backend == "gloo":
        device = f"cuda:{args.rank % torch.cuda.device_count()}"
    pm.init_group(args.backend, args.init, args.ranks, args.rank)
    try:
        mesh = pm.make_mesh(args.ranks,
                            device=None if args.backend == "nccl" else device)
        problem = torch.load(args.payload, weights_only=False)
        out = sharded_outputs(mesh, problem)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib",
                                               "circminer_tpu"))
        if leaked:
            raise RuntimeError(f"rank {args.rank} loaded {leaked[:5]}")
        if args.rank == 0:
            torch.save(out, os.path.join(args.out, "rank0.pt"))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def single_outputs(p: dict, device) -> dict:
    """The single-process steps on the whole of problem ``p``: the map
    step on one device, the replicated lookup and chain the index-sharded
    map step must equal, and the fused device-full step; numpy
    outputs."""
    from .ops.chain_device import chain_batch_device
    from .ops.device_full import device_full_step
    from .ops.seed import gather_seeds_device, lookup_batch_device
    from .parallel.mesh import Mesh, replicate
    one = Mesh(None, 0, 1, resolve_device(device))

    def put(a):
        return replicate(one, a)
    cfg, ci, st = p["cfg"], p["ci"], p["statics"]
    ad, fa = put(p["ad"]), put(p["fa"])
    hv, cs, ep, codes = (put(getattr(ci, n)) for n in
                         ("entry_hv", "entry_checksum", "entry_pos", "codes"))
    reads, lens = put(p["reads"]), put(p["lens"])
    *maps, total = _one_device_map_step(cfg, st["seg_pad"], p["seed_cap"],
                                        device)(reads, lens, hv, cs, ep,
                                                *_anno_args(ad))
    out = {"map": tuple(t.cpu().numpy() for t in maps) + (int(total),)}
    # the replicated lookup and chain over every non-overlapping list
    qpos_d, start_d, cnt_d, hh_d = lookup_batch_device(
        reads, lens, hv, cs, k=cfg.kmer, cs_len=cfg.checksum_len,
        n_slots=cfg.max_seg_cnt, seed_lim=cfg.seed_lim)
    cnt_c = cnt_d[:, ::2]
    pos_r, _ = gather_seeds_device(ep, start_d[:, ::2], cnt_c,
                                   cap=p["seed_cap"])
    dp_r, back_r = chain_batch_device(
        pos_r, cnt_c, torch.clamp(qpos_d[:, ::2], min=0), lens,
        *_anno_args(ad), k=cfg.kmer, max_ed=cfg.max_ed,
        max_intron=cfg.max_intron, seg_pad=st["seg_pad"])
    out["index_map"] = tuple(t.cpu().numpy() for t in (
        dp_r, back_r, pos_r, cnt_c,
        hh_d[:, ::2].sum(dim=1, dtype=torch.int32)))
    out["full"] = device_full_step(
        put(p["seqs4"]), put(p["lens4"]), put(p["mr_in"]), hv, cs, ep,
        codes, ad, fa, put(p["prefix"]), contig_num=p["contig_num"],
        prefix_shift=p["prefix_shift"], prefix_iters=p["prefix_iters"],
        **st).cpu().numpy()
    return out


def dryrun_multichip(n_devices: int, device="cuda", backend: str = "gloo",
                     timeout: float = 600.0) -> None:
    """Every sharded step over ``n_devices`` ranks (``run_ranks``) on one
    tiny step, asserting what the reference's dry run asserts: shapes, the
    all-reduced seed total, the BSJ merge carrying live payloads, and the
    replicated- and index-sharded full steps bit-equal to the
    single-process step; here the two map steps are held bit-equal to their
    single-process forms too."""
    p = mesh_problem(n_devices)
    want = single_outputs(p, device)
    got = run_ranks(n_devices, p, backend=backend, device=device,
                    timeout=timeout)
    B = p["reads"].shape[0]
    dp10, back, pos_b, hh, total = got["map"]
    assert dp10.shape[0] == B and total >= 0
    for name in ("map", "index_map"):
        for i, (g, w) in enumerate(zip(got[name], want[name])):
            assert np.array_equal(g, w), \
                f"{name} output {i} diverged from the single process"
    cg, ng = got["merge"]
    cg_h = cg.reshape(-1, 2)
    assert cg_h.shape[0] == B
    # the gathered set is the union of the ranks' contributions
    first = want["map"][2][:, 0, 0]
    assert np.array_equal(np.sort(cg_h[:, 0]), np.sort(first))
    assert np.array_equal(cg_h[:, 1], cg_h[:, 0] + 100)
    assert int(ng.sum()) == B
    for name in ("full", "index_full"):
        assert got[name].shape == want["full"].shape
        assert np.array_equal(got[name], want["full"]), \
            f"{name} step diverged from the single process"
    print(f"dryrun_multichip({n_devices}): ok on {got['backend']} "
          f"({device}) — dp10 {dp10.shape}, total seeds {total}, gathered "
          f"{cg.shape}, index-sharded dp10 {got['index_map'][0].shape}, "
          f"full-step parity {got['full'].shape} bit-equal, index-sharded "
          f"full-step parity bit-equal; step ms {got['ms']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m circminer_tpu_torch.graft_entry",
        description="single-device mapping step, then the multi-process "
                    "dry run of every sharded step")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the CUDA device "
                         "count, 2 on the CPU)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: nccl on cuda, gloo on the CPU")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--payload", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    if args.rank is not None:
        args.backend = backend
        return _rank_main(args)
    fn, ex = entry(args.device)
    out = fn(*ex)
    _sync(out[0].device)
    print("entry(): run ok", [tuple(o.shape) for o in out])
    n = args.ranks or (torch.cuda.device_count() if args.device == "cuda"
                       else 2)
    dryrun_multichip(n, device=args.device, backend=backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
