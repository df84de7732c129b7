"""Global configuration for circminer-tpu.

Mirrors the reference CircMiner's flag set and hard thresholds
(reference: src/commandline_parser.cpp:7-33, src/common.h:39-53) but as an
explicit dataclass instead of mutable globals, so that jitted device code can
close over a frozen config and host code can thread it explicitly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

# --- hard constants (reference: src/common.h:39-53) ---
MAXLINESIZE = 600
MINKMER = 15
MAXDISCRDTLEN = 20000
BPRES = 5           # breakpoint resolution when matching exon boundaries
EDTH = 4            # default max edit distance per mate
INDELTH = 3         # default band width
SOFTCLIPTH = 7      # default max soft-clip length
MAXTLEN = 500
FRAGLIM = 500       # seed occurrence cap
MAXINTRON = 2_000_000
BESTCHAINLIM = 30
LARIAT2BEGTH = 1000

# contig packing (reference: src/common.h:79-82)
DEF_CONTIG_SIZE = 1_100_000_000
DEF_CONTIG_MAX_SIZE = 1_300_000_000

# mapping output categories, priority-ordered (reference: src/common.h:56-72)
CONCRD = 0
DISCRD = 1
CHIORF = 2
CHIBSJ = 3
CHI2BSJ = 4
CONGEN = 5
CHIFUS = 6
CONGNM = 7
OEA2 = 8
CANDID = 9
OEANCH = 10
ORPHAN = 11
NOPROC_MANYHIT = 12
NOPROC_NOMATCH = 13
CATNUM = 14

CATEGORY_NAMES = [
    "CONCRD", "DISCRD", "CHIORF", "CHIBSJ", "CHI2BSJ", "CONGEN", "CHIFUS",
    "CONGNM", "OEA2", "CANDID", "OEANCH", "ORPHAN", "NOPROC_MANYHIT",
    "NOPROC_NOMATCH",
]

# circRNA candidate types (reference: src/process_circ.h:14-20)
FR = 0
RF = 1
CR = 20
NCR = 21
MCR = 22
UD = 30
NF = 40

CIRC_TYPE_NAMES = {CR: "STC", NCR: "MTC", MCR: "NC"}

# mapping report formats (reference: src/common.h:75-77)
DISCARDMAPREPORT = 0
PAMFORMAT = 1
SAMFORMAT = 2

# k-mer index geometry (reference: src/common.cpp:7-8)
WINDOW_SIZE = 14
MAX_CHECKSUM_LEN = 8

INF = int(1e9)
MINLB = 0
MAXUB = 4294967295


@dataclasses.dataclass(frozen=True)
class Config:
    """Run configuration (reference defaults: src/commandline_parser.cpp:7-33)."""

    # index geometry
    kmer: int = 20                 # WINDOW_SIZE + checksum length
    window_size: int = WINDOW_SIZE

    # thresholds
    max_ed: int = EDTH             # -e / --max-ed
    max_sc: int = SOFTCLIPTH       # -c / --max-sc
    band_width: int = INDELTH      # -w / --band
    seed_lim: int = FRAGLIM        # -S / --seed-lim
    max_tlen: int = MAXTLEN        # -T / --max-tlen
    max_intron: int = MAXINTRON    # -I / --max-intron
    max_chain_len: int = BESTCHAINLIM  # -C / --max-chain-list
    max_read_len: int = 300        # -l / --rlen

    # behavior
    scan_level: int = 0            # -a / --scan-lev
    stage: int = 2                 # -q / --stage (0: map, 1: circ, 2: both)
    report_mapping: int = DISCARDMAPREPORT  # --sam / --pam
    paired_end: bool = True
    compact_index: bool = False    # -m
    final_cleaning: bool = True    # -z disables
    internal_sort: bool = False    # -Z
    threads: int = 1

    # circ stage geometry (reference: circminer.cpp:348, process_circ.cpp:60)
    circ_window: int = 8
    circ_step: int = 3

    # device batching knobs (no reference equivalent; TPU-native)
    batch_size: int = 4096
    seed_buckets: tuple = (16, 128, FRAGLIM)  # occupancy bucketing for chain DP

    @property
    def checksum_len(self) -> int:
        return max(0, self.kmer - self.window_size)

    @property
    def resolved_threads(self) -> int:
        """Native-kernel thread count with the reference's -t semantics
        (commandline_parser.cpp:148-151): values < 1 or > nproc mean
        'use every core'."""
        ncpu = os.cpu_count() or 1
        t = self.threads
        return ncpu if (t < 1 or t > ncpu) else t

    @property
    def max_seg_cnt(self) -> int:
        """Number of k-mer list slots (reference: circminer.cpp:161)."""
        return 2 * ((self.max_read_len + self.kmer - 1) // self.kmer) - 1

    @property
    def n_kmer_lists(self) -> int:
        """Non-overlapping k-mer list count for a max-length read."""
        return (self.max_read_len + self.kmer - 1) // self.kmer

    def validate(self) -> "Config":
        if not (self.window_size <= self.kmer <= self.window_size + MAX_CHECKSUM_LEN):
            raise ValueError(
                f"kmer size must be in [{self.window_size}, "
                f"{self.window_size + MAX_CHECKSUM_LEN}], got {self.kmer}"
            )
        return self


DEFAULT_CONFIG = Config()
