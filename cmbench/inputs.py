"""What a run reads: the cell's configuration and traffic files, the
configuration's genome and annotation, and the libraries drawn from the
seed.

Everything made once per configuration is kept under ``cmbench/.cache/``
inside the checkout, at a path named by the configuration and a hash of
what makes it, so that only a cell's first run in a checkout builds it:

- ``inputs/<config>-<hash>/``: the genome as FASTA and its annotation as
  GTF, made by ``cmbench/sim.py`` (hash: its source and the genome's sizes);
- ``port/<config>-<hash>/``: the port's packed genome, index and
  annotation (hash: the inputs' and the port's sources that make them);
- ``reference/<config>-<hash>/``: the reference's own, made by its frozen
  copy of the same code.

The libraries are drawn anew in every run from ``--seed`` and written as
R1 / R2 FASTQ pairs into a temporary directory under ``TMPDIR``.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import sys
from typing import Dict, List, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")

# the port's and the reference's sources that make a configuration's index
# and annotation: a change to any of them names a new cache directory
SETUP_SOURCES = ("config.py", "ops/encode.py", "io/fasta.py", "io/gtf.py",
                 "index/build.py", "annotation/annotation.py")


def load_benchmark(path: str = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    """``cmbench/<kind>/<name>.json``."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> Tuple[dict, dict, dict]:
    """(the workload's entry, its configuration, its traffic) by name."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    return w, config, load_json("traffic", w["traffic"])


def digest(paths: List[str], extra: str = "") -> str:
    h = hashlib.sha256(extra.encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def _atomic_pickle(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=4)
    os.replace(tmp, path)


def genome_files(name: str, config: dict) -> Tuple[str, str]:
    """(FASTA, GTF) of the configuration's genome, made when absent."""
    from . import sim
    g = config["genome"]
    key = digest([sim.__file__], json.dumps(g, sort_keys=True))
    d = os.path.join(CACHE, "inputs", f"{name}-{key}")
    fa, gtf = os.path.join(d, "ref.fa"), os.path.join(d, "ref.gtf")
    kept = os.path.join(d, "genome.pkl")
    if not all(os.path.exists(p) for p in (fa, gtf, kept)):
        os.makedirs(d, exist_ok=True)
        genome = sim.make_genome(np.random.default_rng(g["seed"]),
                                 length=g["length"], n_genes=g["n_genes"],
                                 dup_frac=g["dup_frac"])
        for path, write in ((gtf, genome.write_gtf),
                            (fa, genome.write_fasta)):
            write(f"{path}.tmp")
            os.replace(f"{path}.tmp", path)
        _atomic_pickle(genome, kept)
    return fa, gtf


def indexed(kind: str, pkg, name: str, config: dict, cfg, fa: str,
            gtf: str):
    """(genome index, annotation) of ``pkg`` (the port's package or the
    reference's) over the configuration's genome, kept as a pickle under
    ``.cache/<kind>/`` and made there when absent."""
    root = os.path.dirname(os.path.abspath(pkg.__file__))
    key = digest([fa, gtf] + [os.path.join(root, s) for s in SETUP_SOURCES],
                 f"k{cfg.kmer}")
    d = os.path.join(CACHE, kind, f"{name}-{key}")
    made = os.path.join(d, "setup.pkl")
    if os.path.exists(made):
        with open(made, "rb") as f:
            return pickle.load(f)
    os.makedirs(d, exist_ok=True)
    sys.stderr.write(f"[cmbench] building the {kind}'s index of {name}\n")
    ref = os.path.join(d, "ref.fa")
    if not os.path.exists(ref):
        os.symlink(fa, ref)
    fasta = __import__(f"{pkg.__name__}.io.fasta", fromlist=["x"])
    build = __import__(f"{pkg.__name__}.index.build", fromlist=["x"])
    anno = __import__(f"{pkg.__name__}.annotation.annotation",
                      fromlist=["x"])
    contigs, info = fasta.GenomePacker(ref).pack_genome()
    gi = build.build_genome_index(contigs, cfg)
    db = anno.AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                                    contig_lengths=[len(c) for c in contigs])
    _atomic_pickle((gi, db), made)
    return gi, db


def run_config(pkg, config: dict):
    """The configuration's ``Config`` of ``pkg`` (the port's or the
    reference's)."""
    mod = __import__(f"{pkg.__name__}.config", fromlist=["Config"])
    return mod.Config(**config["config"]).validate()


def write_libraries(genome_fa: str, config: dict, traffic: dict, seed: int,
                    out_dir: str) -> List[Dict]:
    """Draw ``traffic["libraries"]`` distinct libraries from ``seed``, each
    ``config["library_pairs"]`` pairs of which a ``traffic["circ_frac"]`` share
    comes from circular fragments, with the configuration's read length,
    fragment lengths and error rate; write each as an R1 / R2 FASTQ pair
    into ``out_dir``.  Returns [{"r1", "r2", "pairs"}]."""
    from . import sim
    genome = genome_from_files(genome_fa)
    r = config["reads"]
    n = int(config["library_pairs"])
    n_circ = int(round(n * float(traffic["circ_frac"])))
    libs = []
    for lib in range(int(traffic["libraries"])):
        rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), lib])
        reads, _ = sim.simulate_reads(
            rng, genome, n - n_circ, n_circ, read_len=r["read_len"],
            frag_len=tuple(r["frag_len"]), err_rate=r["err_rate"],
            name_prefix=f"s{lib}_")
        # linear and circular fragments interleaved, as a library has them
        order = rng.permutation(len(reads))
        reads = [reads[i] for i in order]
        r1 = os.path.join(out_dir, f"lib{lib}_R1.fq")
        r2 = os.path.join(out_dir, f"lib{lib}_R2.fq")
        sim.write_fastq(reads, r1, r2)
        libs.append(dict(r1=r1, r2=r2, pairs=len(reads)))
    return libs


def genome_from_files(genome_fa: str):
    """The SimGenome of a configuration (sequence and genes), as
    ``genome_files`` keeps it beside the FASTA."""
    with open(os.path.join(os.path.dirname(genome_fa), "genome.pkl"),
              "rb") as f:
        return pickle.load(f)
