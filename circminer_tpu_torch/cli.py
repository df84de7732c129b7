"""Command-line interface of the torch port.

Takes the reference's flags (``circminer_tpu.cli.build_parser``) with the
port's executors:

    python -m circminer_tpu_torch.cli --index -r ref.fa -k 20
    python -m circminer_tpu_torch.cli -r ref.fa -g ref.gtf -1 R1.fq -2 R2.fq \\
        -o out --pam --device gpu-wave [--torch-device cuda|cpu]

``--device``: ``gpu`` = seed lookup on the torch device, chaining and the
finish in host C++; ``gpu-chain`` = lookup and chain DP on the device,
k-best extraction and the finish in host C++; ``gpu-full`` = the whole map
step on the device (the fused device-full step), deferred reads replayed in
host C++; ``gpu-wave`` = device lookup plus wave-batched extension on the
hand-written DP kernels; ``native`` = everything in host C++.
``--torch-device`` picks the torch device of the device executors (``cuda``
by default; ``cpu`` runs their plain torch versions).  Stage 2 (circRNA
calling) is the shared host C++ engine.  Not ported yet: single-end mapping
(-s), multi-host runs, --trace-dir and the stage-2 device extension.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from circminer_tpu.cli import build_parser as _reference_parser
from circminer_tpu.cli import config_from_args, run_index
from circminer_tpu.config import PAMFORMAT, SAMFORMAT

# --device -> (chain_exec, extend_exec) of the port's pipeline
EXECUTORS = {"gpu": ("device", "native"),
             "gpu-chain": ("device-chain", "native"),
             "gpu-full": ("device-full", "native"),
             "gpu-wave": ("device", "device"),
             "native": ("native", "native")}


def build_parser() -> argparse.ArgumentParser:
    # the reference's flags, with --device replaced by the port's executors
    p = argparse.ArgumentParser(
        prog="circminer-torch",
        description="circRNA detection, PyTorch + CUDA port of circminer-tpu",
        parents=[_reference_parser()], conflict_handler="resolve")
    p.add_argument("--device", choices=sorted(EXECUTORS), default="gpu",
                   help="mapping executor: gpu = seed lookup on the torch "
                        "device, chain + finish in host C++ (default); "
                        "gpu-chain = lookup + chain DP on the device; "
                        "gpu-full = the fused map step on the device; "
                        "gpu-wave = device lookup + wave-batched extension "
                        "on the CUDA DP kernels; native = all host C++")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="read pairs per device batch (the fused gpu-full "
                        "step sizes its DP pools from it)")
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of the device executors (cpu runs "
                        "their plain torch versions)")
    return p


def _unported(args, cfg) -> str:
    if not cfg.paired_end:
        return ("single-end mapping (-s) is not ported to circminer_tpu_torch "
                "yet; use circminer_tpu.cli for single-end reads")
    if args.coordinator or (args.num_hosts or 1) > 1:
        return "multi-host runs are not ported to circminer_tpu_torch yet"
    if args.trace_dir:
        return "--trace-dir is not ported to circminer_tpu_torch yet"
    return ""


def run_search(args, cfg) -> int:
    import os
    from circminer_tpu.annotation.annotation import AnnotationDB
    from circminer_tpu.config import Config
    from circminer_tpu.index.build import load_genome_index
    from circminer_tpu.io.fasta import GenomePacker, chrloc2conloc
    from circminer_tpu.io.fastq import (RemainWriter, iter_sorted_remain,
                                        read_pairs)
    from circminer_tpu.pipeline.circ import ProcessCirc
    from circminer_tpu.pipeline.output import SamOutput
    from circminer_tpu.utils.logging import set_trace_level
    from .pipeline.device_pipeline import DeviceMappingPipeline

    set_trace_level(args.verbosity)
    gp = GenomePacker(args.reference)
    info = gp.load_index_info()
    if os.path.exists(gp.index_fname + ".npz"):
        gi = load_genome_index(gp.index_fname)
    else:
        from circminer_tpu.index.mrsfast_format import read_mrsfast_index
        gi = read_mrsfast_index(gp.index_fname)
    cfg = Config(**{**cfg.__dict__, "kmer": gi.kmer})
    n_contigs = GenomePacker.packed_contig_cnt(info)
    print(f"[INFO] loaded index: {n_contigs} contig(s), kmer={gi.kmer}",
          file=sys.stderr)
    db = AnnotationDB.from_gtf(
        args.gtf, info, n_contigs, cfg,
        contig_lengths=[c.length for c in gi.contigs])
    print("[INFO] GTF loaded", file=sys.stderr)
    fmt = {SAMFORMAT: "sam", PAMFORMAT: "pam"}.get(cfg.report_mapping)
    last_round = n_contigs

    if cfg.stage != 1:
        out = SamOutput(args.output, fmt, info)
        remain = RemainWriter(args.output, last_round)

        def conloc(chrname, s, e):
            return chrloc2conloc(db.chr2con, chrname, s, e)

        def pairs_with_ordinal():
            # the circ-stage sort tie-breaks on the global pair ordinal
            for k, (r1, r2) in enumerate(read_pairs(args.seq1, args.seq2,
                                                    cfg)):
                r1.ordinal = k
                yield r1, r2

        chain_exec, extend_exec = EXECUTORS[args.device]
        pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=args.batch_size,
                                     chain_exec=chain_exec,
                                     extend_exec=extend_exec,
                                     device=args.torch_device)
        pipe.warmup()
        n = pipe.map_stream_all_contigs(pairs_with_ordinal(), out, remain,
                                        conloc)
        if pipe.wave_stats["batches"]:
            ws, sv = pipe.wave_stats, pipe.align_svc
            print(f"[INFO] wave engine: {ws['waves']} waves over "
                  f"{ws['batches']} batch(es), {sv.n_dispatch} dispatches, "
                  f"{sv.n_device} device / {sv.n_host} host requests",
                  file=sys.stderr)
        fs = pipe.full_stats
        if fs["reads"]:
            print(f"[INFO] device-full: {fs['reads']} reads, "
                  f"{fs['deferred']} deferred to the host "
                  f"{dict(sorted(fs['causes'].items()))}", file=sys.stderr)
        out.close()
        remain.close()
        print(f"[INFO] mapping done: {n} pairs", file=sys.stderr)

    if cfg.stage != 0:
        recs = iter_sorted_remain(
            f"{args.output}_{last_round}_remain_R1.fastq",
            f"{args.output}_{last_round}_remain_R2.fastq", cfg,
            internal=cfg.internal_sort)
        pc = ProcessCirc(db, gi, cfg, args.output)
        # stage-2 extension runs in the shared host C++ engine; its device
        # form (which the reference's tpu-full turns on) is a later port
        if args.device == "gpu-full":
            print("[INFO] stage 2 runs on the host: the stage-2 device "
                  "extension is not ported to circminer_tpu_torch yet",
                  file=sys.stderr)
        pc.run(recs, device_ext=False)
        pc.report_events(args.output + ".circ_report")
        pc.write_candidates(args.output + ".candidates.pam")
        print(f"[INFO] circRNA detection done: {len(pc.circ_res)} candidate "
              f"reads, report at {args.output}.circ_report", file=sys.stderr)
    return 0


def main(argv: List[str] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.index:
        return run_index(args, cfg)
    if not args.gtf or (not args.seq and not args.seq1):
        print("error: search mode needs -g and -1/-2", file=sys.stderr)
        return 1
    if args.batch_size < 1:
        print("error: --batch-size must be at least 1", file=sys.stderr)
        return 1
    why = _unported(args, cfg)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    return run_search(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
