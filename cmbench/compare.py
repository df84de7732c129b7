"""What decides ``correct``: the program's outputs against the plain
reference's, pair by pair and event by event.

For every pass of the window, three numbers are compared, each with the
limit 0 (the outputs are integers and strings, so the comparison is
exact):

- ``pair_mismatches``: pairs whose final MatchedRead (every field but the
  ``touched`` marker, after writeback and host replay) differs from the
  reference's for the same pair of the same library.  A pass keeps one
  hash of each pair's fields (64 bits, so two states that differ share
  one by chance once in 2**64), and the states themselves only where
  they are wanted for the log, so that the window's passes do not pile
  up a library's objects each;
- ``event_mismatches``: called events (``ProcessCirc.circ_res``: chromosome,
  read, both breakpoints, type, signals and references) and candidate lines
  in one output and not the other, counted as a multiset difference;
- ``report_mismatches``: passes whose ``circ_report`` bytes differ.

It also names the modules a run may not hold: ``jax``, ``jaxlib``,
``flax`` and the JAX package ``circminer_tpu``, compared by whole top-level
name, so that the port ``circminer_tpu_torch`` is not one of them.
"""

from __future__ import annotations

import collections
import dataclasses
import operator
from typing import Dict, Iterable, List, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "circminer_tpu")
LIMITS = {"pair_mismatches": 0, "event_mismatches": 0,
          "report_mismatches": 0}

MR_FIELDS = ("spos_r1", "spos_r2", "epos_r1", "epos_r2", "qspos_r1",
             "qspos_r2", "qepos_r1", "qepos_r2", "mlen_r1", "mlen_r2",
             "r1_forward", "r2_forward", "ed_r1", "ed_r2", "type", "tlen",
             "junc_num", "gm_compatible", "contig_num", "genome_spos",
             "chr_r1", "chr_r2")
_STATE = operator.attrgetter(*MR_FIELDS)


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level package (the part before
    the first dot) is one of FORBIDDEN, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def states(mrs) -> List[tuple]:
    """Each MatchedRead as the tuple of MR_FIELDS."""
    return [_STATE(mr) for mr in mrs]


def events(circ_res, candid_lines) -> collections.Counter:
    """The called events and candidate lines of a stage-2 run."""
    out = collections.Counter(dataclasses.astuple(c) for c in circ_res)
    out.update(("candidate", line) for line in candid_lines)
    return out


@dataclasses.dataclass
class Outputs:
    """What one pass over a library produced: the hash of each pair's
    state in library order, the events, the report's bytes and, where
    kept, the states themselves."""
    pairs: np.ndarray
    events: collections.Counter
    report: bytes
    states: Optional[List[tuple]] = None


def outputs(mrs, circ_res, candid_lines, report: bytes,
            keep_states: bool) -> Outputs:
    """The Outputs of a pass from its MatchedReads in library order, its
    stage 2's events and candidate lines, and its report's bytes."""
    st = states(mrs)
    return Outputs(np.fromiter(map(hash, st), np.int64, len(st)),
                   events(circ_res, candid_lines), report,
                   st if keep_states else None)


def mismatches(got: Outputs, want: Outputs) -> Dict[str, int]:
    n = min(len(got.pairs), len(want.pairs))
    pairs = max(len(got.pairs), len(want.pairs)) \
        - int((got.pairs[:n] == want.pairs[:n]).sum())
    ev = sum(((got.events - want.events) + (want.events - got.events))
             .values())
    return {"pair_mismatches": pairs, "event_mismatches": ev,
            "report_mismatches": int(got.report != want.report)}


def first_diffs(got: Outputs, want: Outputs, n: int = 3) -> List[str]:
    """The first n pairs whose states differ: their index in the library
    and, where both states are kept, each differing field as program /
    reference."""
    k = min(len(got.pairs), len(want.pairs))
    out = []
    for i in np.flatnonzero(got.pairs[:k] != want.pairs[:k])[:n].tolist():
        if got.states is None or want.states is None:
            out.append(f"pair {i}")
            continue
        out.append(f"pair {i}: " + ", ".join(
            f"{f} {a!r}/{b!r}" for f, a, b in zip(
                MR_FIELDS, got.states[i], want.states[i]) if a != b))
    return out


def judge(passes: List[Outputs], libs: List[int],
          wants: Dict[int, Outputs], log=None) -> Dict[str, int]:
    """The summed mismatches of every pass against the reference's outputs
    of its library (``libs[i]`` is pass i's library); each pass that
    differs is described to ``log`` (a callable taking a line)."""
    tot = dict.fromkeys(LIMITS, 0)
    for k, (got, lib) in enumerate(zip(passes, libs)):
        bad = mismatches(got, wants[lib])
        for key, v in bad.items():
            tot[key] += v
        if log is not None and any(bad.values()):
            log(f"pass {k} (library {lib}): {bad}; "
                + "; ".join(first_diffs(got, wants[lib])))
    return tot
