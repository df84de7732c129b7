"""Stage 2 (circRNA calling) with the extension DPs on the torch device.

The shared ``circminer_tpu.pipeline.circ.ProcessCirc`` is the stage-2
engine; its device path (``run(device_ext=True)`` -> ``_run_device``)
constructs the JAX ``DeviceAlignService`` inside the method.  This subclass
carries its own copy of that method, line for line, with the port's
``DeviceAlignService`` on an explicit torch ``device`` in its place: every
wave of single-split extension requests is one ``wave_all_batch`` per
B-row chunk (the four hand-written DP kernels on the card, their plain
versions on the CPU).  Everything else (gene-local chaining, the sequential
select lattice, reports) is the shared host code, so the outputs equal the
host path's bit for bit.
"""

from __future__ import annotations

from circminer_tpu.config import CHIBSJ
from circminer_tpu.ops.encode import kmer_hashes
from circminer_tpu.pipeline.circ import TOPCHAIN
from circminer_tpu.pipeline.circ import ProcessCirc as _ReferenceProcessCirc
from circminer_tpu.pipeline.extend_batch import run_waves
from circminer_tpu.pipeline.types import MatchedMate
from circminer_tpu.utils.timing import GLOBAL_TIMER as T

from ..device import resolve_device
from ..ops.align_device import DeviceAlignService


class ProcessCirc(_ReferenceProcessCirc):
    """``ProcessCirc`` whose ``run(device_ext=True)`` answers the stage-2
    extension waves on the torch ``device`` ("cuda" by default; "cpu" runs
    the kernels' plain versions)."""

    def __init__(self, db, gi, cfg, output_prefix: str, device="cuda"):
        super().__init__(db, gi, cfg, output_prefix)
        self.device = resolve_device(device)

    def _run_device(self, pairs, group: int = 256) -> None:
        """The reference's ``_run_device`` (speculate-and-select: per sorted
        group a speculative wave phase over every candidate chain's
        find_exact_coord generator, then the sequential select lattice
        against the cached results) with the port's wave service."""
        svc = DeviceAlignService(self.cfg, device=self.device)
        svc.warm()
        pairs = list(pairs)
        i = 0
        n_all = len(pairs)
        while i < n_all:
            contig = pairs[i][0].mr.contig_num
            if contig != self.contig:
                self.load_contig(contig)
            j = i
            while j < n_all and j - i < group \
                    and pairs[j][0].mr.contig_num == contig:
                j += 1
            grp = pairs[i:j]
            i = j
            # ---- speculative wave phase ----
            self.check_removables(grp[0][0].mr.spos_r1)
            gens, keys, pms = [], [], []
            with T.phase("circ_dev_spec"):
                for slot, (r1, r2) in enumerate(grp):
                    if r1.mr.type != CHIBSJ:
                        continue
                    su = self._single_split_setup(r1, r2)
                    if su is None:
                        continue
                    ca = self.db.contigs[self.contig]
                    h_remain = kmer_hashes(su["remain"], self.window_size)
                    gv = su["gene_iv"]
                    forward = (su["mr"].r1_forward if su["r1_partial"]
                               else su["mr"].r2_forward)
                    direction = 1 if forward else -1
                    for e in range(int(ca.gv_seg_off[gv]),
                                   int(ca.gv_seg_off[gv + 1])):
                        gs = int(ca.gv_gene_start[e])
                        ge = int(ca.gv_gene_end[e])
                        gid = int(ca.gv_gene_id[e])
                        ht = self.get_hash_table(gs, ge, gid)
                        chains = self.chaining(su["qspos"], su["qepos"],
                                               ht, su["remain"], gs,
                                               h=h_remain)
                        self._chain_cache[(slot, e)] = chains
                        for ci_, ch in enumerate(chains[:TOPCHAIN]):
                            pm = MatchedMate.default(self.cfg.max_ed)
                            gens.append(self.find_exact_coord_g(
                                su["mm_r1"], su["mm_r2"], pm, direction,
                                su["qspos"], su["remain"],
                                su["remain_len"], su["whole_len"], ch))
                            keys.append((slot, e, ci_))
                            pms.append(pm)
            with T.phase("circ_dev_waves"):
                _, n_waves = run_waves(gens, svc)
            for kk, pm in zip(keys, pms):
                self._fec_cache[kk] = pm
            # ---- sequential select phase (reference lattice order) ----
            with T.phase("circ_dev_select"):
                for slot, (r1, r2) in enumerate(grp):
                    self._spec_key = slot
                    self.call_circ(r1, r2)
            self._spec_key = None
            self._chain_cache.clear()
            self._fec_cache.clear()
        self.dev_align_stats = dict(n_device=svc.n_device,
                                    n_host=svc.n_host,
                                    n_dispatch=svc.n_dispatch)
