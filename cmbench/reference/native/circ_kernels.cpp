// Native circRNA-calling stage (stage 2) for circminer-tpu.
//
// Exact port of pipeline/circ.py (ProcessCirc — itself the port of the
// reference's src/process_circ.cpp:195-1552): per-gene RegionalHashTable,
// gene-local re-chaining (batch_chain, chain_kernels.cpp inlined into this
// .so), exact-coordinate extension, split-map classification, breakpoint
// realignment, and CircRes/candidate emission.  One multithreaded C++ call
// processes the whole position-sorted BSJ stream of a contig; the Python
// side (pipeline/circ.py run_native) only formats report lines.  Parity
// with the Python oracle is pinned by tests/test_circ_e2e.py.
//
// This file is #included at the end of filter_kernels.cpp (same .so): it
// reuses Anno / MM / MR / AR / Extender / Genome / ShiftTab / Cfg and the
// free extension helpers defined there.

namespace {

// circ constants (config.py:57-65, pipeline/circ.py:37-38)
constexpr int C_FR = 0, C_RF = 1, C_CR = 20, C_NCR = 21, C_MCR = 22,
              C_UD = 30, C_NF = 40;
constexpr int BPRES = 5;       // config.py:19
constexpr int TOPCHAIN = 10;   // process_circ.cpp:19
constexpr int MAXHIT_RHT = 1000;  // hash_table.cpp:6

constexpr int RES_W = 16;   // res record width (int64)
constexpr int CAND_W = 24;  // candid record width (int64)

inline char code2char(int8_t c) {
    static const char lut[5] = {'A', 'C', 'G', 'T', 'N'};
    return (c >= 0 && c < 4) ? lut[c] : 'N';
}

// utils.cpp:759-769 (2-char form)
inline void consensus2c(const char* a, const char* b, char* out) {
    if ((a[0] == 0) != (b[0] == 0)) { out[0] = out[1] = 0; return; }
    for (int i = 0; i < 2; ++i)
        out[i] = (a[i] == b[i]) ? a[i] : (a[i] == 0 ? 0 : 'N');
}

// pipeline/circ.py CircRes (chr kept as shift-table index)
struct CRes {
    int64_t spos = 0, epos = 0;
    int type = C_NF;
    int chr_idx = 0;
    char ssig[3] = {0, 0, 0}, esig[3] = {0, 0, 0};
    char sref[3] = {0, 0, 0}, eref[3] = {0, 0, 0};
};

inline void cr_set_c(CRes& cr, int64_t sp, int64_t ep, const char* ss,
                     const char* es, const char* sr, const char* er) {
    cr.spos = sp; cr.epos = ep;
    std::memcpy(cr.ssig, ss, 2); cr.ssig[2] = 0;
    std::memcpy(cr.esig, es, 2); cr.esig[2] = 0;
    std::memcpy(cr.sref, sr, 2); cr.sref[2] = 0;
    std::memcpy(cr.eref, er, 2); cr.eref[2] = 0;
}

// types.py merge_to_right (common.cpp:163-189) — NB: exons_epos is NOT
// copied (bug-compatible with the Python oracle)
inline bool merge_to_right_c(MM& self, const MM& rmm, int max_ed) {
    if (self.dir != rmm.dir) return false;
    self.epos = rmm.epos;
    self.qepos = rmm.qepos;
    self.middle_ed += self.right_ed + rmm.left_ed;
    self.right_ed = rmm.right_ed;
    self.matched_len += rmm.matched_len + self.sclen_right + rmm.sclen_left;
    self.middle_ed += self.sclen_right + rmm.sclen_left;
    self.sclen_right = rmm.sclen_right;
    self.right_ok = rmm.right_ok;
    self.looked_epos = rmm.looked_epos;
    self.exon_ind_epos = rmm.exon_ind_epos;
    return self.left_ed + self.middle_ed + self.right_ed <= max_ed;
}

// categories.py same_transcript3 (utils.cpp:356-376; quirk preserved:
// intersects (a&b) with a again, not with c)
inline void same_transcript3_c(const Anno& an, int32_t iv_a, int32_t iv_b,
                               int32_t iv_c, std::vector<int32_t>& out) {
    out.clear();
    if (iv_a < 0 || iv_b < 0 || iv_c < 0) return;
    std::vector<int32_t> ab, ta;
    same_transcript2(an, iv_a, iv_b, ab);
    if (ab.empty()) return;
    an.interval_tids(iv_a, ta);
    intersect_tids(ab, ta, out);
}

inline void same_transcript4_c(const Anno& an, int32_t iv_a, int32_t iv_b,
                               int32_t iv_c, int32_t iv_d,
                               std::vector<int32_t>& out) {
    out.clear();
    if (iv_a < 0 || iv_b < 0 || iv_c < 0 || iv_d < 0) return;
    std::vector<int32_t> ab, cd;
    same_transcript2(an, iv_a, iv_b, ab);
    if (ab.empty()) return;
    same_transcript2(an, iv_c, iv_d, cd);
    if (cd.empty()) return;
    intersect_tids(ab, cd, out);
}

// categories.py same_transcript_multi (utils.cpp:419-603): spos/epos combos
// in the reference's order.  iv(mm, 1) = epos interval (lazy lookup).
inline int32_t stm_iv(MM& mm, const Anno& an, int use_epos) {
    if (use_epos) { overlap_to_epos(mm, an); return mm.exons_epos; }
    return mm.exons_spos;
}

inline void same_transcript_multi_c(const Anno& an, MM** segs, int size,
                                    std::vector<int32_t>& out) {
    out.clear();
    for (int i = 0; i < size; ++i) overlap_to_spos(*segs[i], an);
    if (size == 3) {
        static const int combos3[8][3] = {
            {0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
            {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1}};
        for (auto& c : combos3) {
            same_transcript3_c(an, stm_iv(*segs[0], an, c[0]),
                               stm_iv(*segs[1], an, c[1]),
                               stm_iv(*segs[2], an, c[2]), out);
            if (!out.empty()) return;
        }
    } else if (size == 4) {
        static const int combos4[16][4] = {
            {0, 0, 0, 0}, {0, 0, 1, 0}, {0, 1, 0, 0}, {0, 1, 1, 0},
            {1, 0, 0, 0}, {1, 0, 1, 0}, {1, 1, 0, 0}, {1, 1, 1, 0},
            {0, 0, 0, 1}, {0, 0, 1, 1}, {0, 1, 0, 1}, {0, 1, 1, 1},
            {1, 0, 0, 1}, {1, 0, 1, 1}, {1, 1, 0, 1}, {1, 1, 1, 1}};
        for (auto& c : combos4) {
            same_transcript4_c(an, stm_iv(*segs[0], an, c[0]),
                               stm_iv(*segs[1], an, c[1]),
                               stm_iv(*segs[2], an, c[2]),
                               stm_iv(*segs[3], an, c[3]), out);
            if (!out.empty()) return;
        }
    } else if (size == 2) {
        static const int combos2[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
        for (auto& c : combos2) {
            same_transcript2(an, stm_iv(*segs[0], an, c[0]),
                             stm_iv(*segs[1], an, c[1]), out);
            if (!out.empty()) return;
        }
    }
}

// categories.py get_junctions (utils.cpp:697-757)
inline void get_junctions_c(const Anno& an, MM& mm, int indel_th = 3) {
    overlap_to_spos(mm, an);
    overlap_to_epos(mm, an);
    mm.junc_info.clear();
    if (mm.exons_spos < 0 || mm.exons_epos < 0) return;
    for (int64_t e = an.iv_seg_off[mm.exons_spos];
         e < an.iv_seg_off[mm.exons_spos + 1]; ++e) {
        int32_t u = an.seg_uid[e];
        if (u < 0) continue;
        for (int64_t t = an.uid_tid_off[u]; t < an.uid_tid_off[u + 1]; ++t) {
            int tid = an.uid_tid[t];
            int start_ind = an.trans_start[tid];
            int start_ti = mm.exon_ind_spos - start_ind;
            if (start_ti < 0) continue;
            int end_ti = mm.exon_ind_epos - start_ind;
            if (mm.exon_ind_epos < start_ind || end_ti >= an.t2s_len(tid) ||
                an.t2s(tid, end_ti) == 0)
                continue;
            if (start_ti == end_ti) return;
            int64_t junc_start = (int64_t)an.iv_epos[mm.exons_spos];
            int64_t covered = (int64_t)an.iv_epos[mm.exons_spos] -
                              mm.spos + 1;
            int32_t this_iv = mm.exon_ind_spos;
            std::vector<JuncI> infos;
            for (int kk = start_ti + 1; kk < end_ti; ++kk) {
                ++this_iv;
                if (an.t2s(tid, kk) != 0) {
                    if (junc_start < (int64_t)an.iv_spos[this_iv])
                        infos.push_back(JuncI{junc_start,
                                              (int64_t)an.iv_spos[this_iv],
                                              (int)covered});
                    covered += (int64_t)an.iv_epos[this_iv] -
                               (int64_t)an.iv_spos[this_iv] + 1;
                    junc_start = (int64_t)an.iv_epos[this_iv];
                }
            }
            if (junc_start < (int64_t)an.iv_spos[mm.exons_epos])
                infos.push_back(JuncI{junc_start,
                                      (int64_t)an.iv_spos[mm.exons_epos],
                                      (int)covered});
            covered += mm.epos - (int64_t)an.iv_spos[mm.exons_epos] + 1;
            mm.junc_info = infos;
            int64_t d = covered - mm.matched_len;
            if ((d < 0 ? -d : d) <= indel_th) return;
            mm.junc_info.clear();
        }
    }
}

// ---- gene view (annotation.py gv_* arrays) --------------------------------
struct GeneView {
    const uint32_t *gv_spos, *gv_epos;
    int32_t n_gv;
    const int64_t* gv_seg_off;
    const uint32_t *gv_gene_start, *gv_gene_end;
    const int32_t* gv_gene_id;

    // annotation.py gene_overlap: gene-interval index containing pos or -1
    int32_t gene_overlap(int64_t pos) const {
        if (n_gv <= 0 || pos < (int64_t)gv_spos[0]) return -1;
        int32_t lo = 0, hi = n_gv;
        while (lo < hi) {
            int32_t mid = (lo + hi) >> 1;
            if ((int64_t)gv_spos[mid] <= pos) lo = mid + 1; else hi = mid;
        }
        int32_t ind = lo - 1;
        if (ind < 0 || (int64_t)gv_epos[ind] < pos) return -1;
        if (gv_seg_off[ind + 1] == gv_seg_off[ind]) return -1;
        return ind;
    }
};

// ---- chain-DP annotation arrays (ops/chain_native.py NativeChainer) -------
struct ChainArgs {
    const uint8_t* nb; int64_t nb_len;
    const int32_t *iv_spos, *iv_epos, *iv_max_end, *iv_min_end, *iv_max_next;
    const int64_t* iv_seg_off;
    const int32_t *seg_end, *seg_next;
    int32_t n_iv;
};

// ---- RegionalHashTable (pipeline/circ.py:60-102; src/hash_table.cpp) ------
// Dense per-gene w-mer bucket table (counting sort keeps gene-local
// positions ascending per bucket, matching the sorted-array Python form).
struct RegionalHT {
    int64_t gene_end = 0;
    int w = 0;
    std::vector<int32_t> off;   // [4^w + 1]
    std::vector<int32_t> locs;  // 0-based gene-local starts

    void build(const int8_t* seq, int64_t len, int w_) {
        w = w_;
        const int32_t nb = 1 << (2 * w);
        off.assign((size_t)nb + 1, 0);
        locs.clear();
        if (!seq || len < w) return;
        const int64_t L = len - w + 1;
        std::vector<int32_t> hv((size_t)L);
        rolling(seq, len, w, hv.data());
        for (int64_t i = 0; i < L; ++i)
            if (hv[i] >= 0) ++off[hv[i] + 1];
        for (int32_t b = 0; b < nb; ++b) off[b + 1] += off[b];
        locs.resize(off[nb]);
        std::vector<int32_t> cur(off.begin(), off.end() - 1);
        for (int64_t i = 0; i < L; ++i)
            if (hv[i] >= 0) locs[cur[hv[i]]++] = (int32_t)i;
    }

    // ops/encode.py kmer_hashes: big-endian 2-bit rolling hash, -1 where
    // the window contains an N (base >= 4)
    static void rolling(const int8_t* seq, int64_t len, int w_,
                        int32_t* out) {
        const int64_t L = len - w_ + 1;
        const int32_t mask = (1 << (2 * w_)) - 1;
        int32_t hv = 0;
        int64_t last_n = -1;
        for (int64_t i = 0; i < len; ++i) {
            int8_t b = seq[i];
            if (b < 0 || b >= 4) { last_n = i; hv = (hv << 2) & mask; }
            else hv = ((hv << 2) | b) & mask;
            int64_t s = i - w_ + 1;
            if (s >= 0 && s < L) out[s] = (last_n >= s) ? -1 : hv;
        }
    }
};

// ---- per-worker context ----------------------------------------------------
struct CircCtx {
    const Anno* an;
    const ChainArgs* ca;
    const GeneView* gv;
    Cfg cfg;                 // align_type == 1 (EDIT)
    Extender ex;
    Genome g;
    ShiftTab shifts;
    int w, step, seed_lim, max_chain;
    int64_t max_intron;

    std::map<int32_t, RegionalHT> ht_cache;

    // per-read sequence slots (pipeline/circ.py member seqs)
    const int8_t *fullmap_seq = nullptr, *remain_seq = nullptr;
    const int8_t *r1_seq = nullptr, *r2_seq = nullptr;
    int fullmap_len = 0, remain_len_q = 0, r1_len = 0, r2_len = 0;

    // output streams (tagged with read_idx; Python re-orders stably)
    std::vector<int64_t> res_out, cand_out;
    int64_t read_idx = 0;

    // chaining scratch
    std::vector<int32_t> hbuf, qpos_b, cnt_b, pos_b;
    std::vector<int32_t> o_rpos, o_qpos, o_clen;
    std::vector<double> o_score;

    void evict(int64_t spos) {
        for (auto it = ht_cache.begin(); it != ht_cache.end();)
            if (it->second.gene_end < spos) it = ht_cache.erase(it);
            else ++it;
    }

    RegionalHT& get_ht(int64_t gs, int64_t ge, int32_t gid) {
        auto it = ht_cache.find(gid);
        if (it != ht_cache.end()) return it->second;
        RegionalHT& ht = ht_cache[gid];
        int64_t glen2 = ge - gs + 1;
        const int8_t* seq = g.get(gs, glen2);
        ht.build(seq, seq ? glen2 : 0, w);
        ht.gene_end = ge;
        return ht;
    }

    const char* pac2(int64_t start, char* buf) {
        const int8_t* s = g.get(start, 2);
        if (s) { buf[0] = code2char(s[0]); buf[1] = code2char(s[1]); }
        else { buf[0] = buf[1] = 'N'; }
        buf[2] = 0;
        return buf;
    }

    void emit_res(const CRes& cr) {
        size_t o = res_out.size();
        res_out.resize(o + RES_W, 0);
        res_out[o + 0] = read_idx;
        res_out[o + 1] = cr.type;
        res_out[o + 2] = cr.chr_idx;
        res_out[o + 3] = cr.spos;
        res_out[o + 4] = cr.epos;
        res_out[o + 5] = cr.ssig[0]; res_out[o + 6] = cr.ssig[1];
        res_out[o + 7] = cr.esig[0]; res_out[o + 8] = cr.esig[1];
        res_out[o + 9] = cr.sref[0]; res_out[o + 10] = cr.sref[1];
        res_out[o + 11] = cr.eref[0]; res_out[o + 12] = cr.eref[1];
    }

    void emit_cand_single(int chr_i, int64_t sh, const MM& pm, const MM& m1,
                          const MM& m2, int typ) {
        size_t o = cand_out.size();
        cand_out.resize(o + CAND_W, 0);
        int64_t* r = cand_out.data() + o;
        r[0] = read_idx; r[1] = 0; r[2] = chr_i;
        const MM* ms[3] = {&pm, &m1, &m2};
        for (int i = 0; i < 3; ++i) {
            r[3 + 5 * i] = ms[i]->spos - sh;
            r[4 + 5 * i] = ms[i]->epos - sh;
            r[5 + 5 * i] = ms[i]->qspos;
            r[6 + 5 * i] = ms[i]->matched_len;
            r[7 + 5 * i] = ms[i]->dir;
        }
        r[18] = typ;
    }

    void emit_cand_double(int chr_i, int64_t sh, const MM& r1p,
                          const MM& r2p, const MM& m1, const MM& m2,
                          int typ) {
        size_t o = cand_out.size();
        cand_out.resize(o + CAND_W, 0);
        int64_t* r = cand_out.data() + o;
        r[0] = read_idx; r[1] = 1; r[2] = chr_i;
        const MM* ms[4] = {&r1p, &r2p, &m1, &m2};
        for (int i = 0; i < 4; ++i) {
            r[3 + 5 * i] = ms[i]->spos - sh;
            r[4 + 5 * i] = ms[i]->epos - sh;
            r[5 + 5 * i] = ms[i]->qspos;
            r[6 + 5 * i] = ms[i]->matched_len;
            r[7 + 5 * i] = ms[i]->dir;
        }
        r[23] = typ;
    }
};

// pipeline/circ.py set_mm (process_circ.cpp:1713-1752)
inline void set_mm_c(const ChainV& ch, int qspos, int rlen, int direction,
                     MM& mm) {
    int64_t spos = ch.r(0);
    int64_t epos = ch.r(ch.len - 1) + ch.f(ch.len - 1) - 1;
    int qepos = qspos + rlen - 1;
    mm.spos = spos; mm.epos = epos;
    mm.qspos = qspos; mm.qepos = qepos;
    mm.matched_len = (qepos + 1 >= qspos) ? (qepos - qspos + 1) : 0;
    mm.dir = direction;
}

// pipeline/circ.py chaining (process_circ.cpp:678-737): gene-local
// re-chaining through batch_chain (R = 1) + the non-increasing missed-kmer
// prefix filter.  Returns number of kept chains; chains are views into
// ctx.o_* buffers.
inline int circ_chaining(CircCtx& C, int qspos, int qepos,
                         const RegionalHT& ht, const int8_t* remain,
                         int remain_total_len, int64_t shift,
                         std::vector<ChainV>& chains) {
    chains.clear();
    const int w = C.w;
    int seq_len = qepos - qspos + 1;
    if (seq_len < w) return 0;
    // hashes of the full remain read (computed once per read by caller into
    // C.hbuf; hbuf length = remain_total_len - w + 1, or empty)
    const int64_t hlen = (int64_t)remain_total_len - w + 1;
    if (hlen <= 0) return 0;

    C.qpos_b.clear(); C.cnt_b.clear();
    std::vector<std::pair<int32_t, int32_t>> ranges;  // bucket [lo, hi)
    for (int64_t idx = qspos - 1; idx <= (int64_t)qepos - w;
         idx += C.step) {
        if (idx >= hlen) break;
        int32_t hv = C.hbuf[idx];
        if (hv < 0) continue;
        C.qpos_b.push_back((int32_t)idx);
        int32_t lo = ht.off.empty() ? 0 : ht.off[hv];
        int32_t hi = ht.off.empty() ? 0 : ht.off[hv + 1];
        int32_t n = hi - lo;
        if (n > MAXHIT_RHT || n > C.seed_lim) { lo = hi = 0; n = 0; }
        ranges.emplace_back(lo, hi);
        C.cnt_b.push_back(n);
    }
    const int NL = (int)C.qpos_b.size();
    if (NL == 0) return 0;
    int cap = 1;
    for (int32_t c : C.cnt_b) cap = std::max(cap, (int)c);
    C.pos_b.assign((size_t)NL * cap, 0);
    for (int l = 0; l < NL; ++l)
        for (int32_t j = ranges[l].first, o = 0; j < ranges[l].second;
             ++j, ++o)
            C.pos_b[(size_t)l * cap + o] = ht.locs[j];

    const int MC = C.max_chain;
    C.o_rpos.assign((size_t)MC * NL, 0);
    C.o_qpos.assign((size_t)MC * NL, 0);
    C.o_clen.assign(MC, 0);
    C.o_score.assign(MC, 0.0);
    int32_t o_n = 0;
    int32_t lens1 = qepos;
    const ChainArgs& A = *C.ca;
    batch_chain(C.pos_b.data(), C.cnt_b.data(), C.qpos_b.data(), &lens1,
                1, NL, cap,
                A.nb, A.nb_len, A.iv_spos, A.iv_epos, A.iv_max_end,
                A.iv_min_end, A.iv_max_next, A.iv_seg_off, A.seg_end,
                A.seg_next, A.n_iv,
                w, C.cfg.max_ed, C.max_intron, MC, shift,
                C.o_rpos.data(), C.o_qpos.data(), C.o_clen.data(),
                C.o_score.data(), &o_n, 1);

    // keep the prefix with non-increasing missed-kmer count
    // (process_circ.cpp:716-736)
    const int kmer_cnt = NL;
    int64_t least_miss = INF;
    for (int c = 0; c < o_n; ++c) {
        int64_t missing = kmer_cnt - C.o_clen[c];
        if (missing > least_miss) break;
        least_miss = missing;
        ChainV cv;
        cv.rpos = C.o_rpos.data() + (size_t)c * NL;
        cv.qpos = C.o_qpos.data() + (size_t)c * NL;
        cv.len = C.o_clen[c];
        cv.score = C.o_score[c];
        cv.k = w;
        chains.push_back(cv);
    }
    return (int)chains.size();
}

// pipeline/circ.py find_exact_coord (process_circ.cpp:739-789)
inline bool find_exact_coord_c(CircCtx& C, MM& mm_r1, MM& mm_r2, MM& pm,
                               int direction, int qspos, const int8_t* rseq,
                               int rlen, int whole_len, const ChainV& bc) {
    const Cfg& cfg = C.cfg;
    set_mm_c(bc, qspos, rlen, direction, pm);
    qspos -= 1;  // 0-based

    overlap_to_spos(mm_r1, *C.an);
    overlap_to_spos(mm_r2, *C.an);
    overlap_to_spos(pm, *C.an);

    MM* segs[3] = {&mm_r1, &mm_r2, &pm};
    std::vector<int32_t> common;
    same_transcript_multi_c(*C.an, segs, 3, common);
    if (common.empty()) return false;

    pm.middle_ed = C.ex.calc_middle_ed(bc, cfg.max_ed, rseq, rlen);
    if (pm.middle_ed > cfg.max_ed) return false;
    pm.is_concord = false;
    if (bc.len <= 0) {
        pm.type = ORPHAN;
        pm.matched_len = 0;
        return false;
    }
    int err = pm.middle_ed;
    pm.matched_len = rlen;
    bool lok = C.ex.extend_chain_left(common, bc, rseq + qspos, qspos,
                                      MINLB, pm, err);
    bool rok;
    if (qspos == 0)
        rok = C.ex.extend_chain_right(common, bc, rseq, rlen, MAXUB, pm,
                                      err);
    else
        rok = C.ex.extend_chain_right(common, bc, rseq, whole_len, MAXUB,
                                      pm, err);
    update_match_mate_info(lok, rok, err, pm, cfg);
    return pm.type == CONCRD;
}

// pipeline/circ.py _collect_bp_tids_end / _start (process_circ.cpp:999-1031,
// 1196-1242)
inline void collect_bp_tids_end(CircCtx& C, const MM& mm_right,
                                std::vector<std::pair<int, int>>& out) {
    out.clear();
    const Anno& an = *C.an;
    int32_t ind = mm_right.exon_ind_epos;
    while (ind >= 0 && ind < an.n_iv &&
           mm_right.spos < (int64_t)an.iv_epos[ind]) {
        for (int64_t e = an.iv_seg_off[ind]; e < an.iv_seg_off[ind + 1];
             ++e) {
            int64_t diff = mm_right.epos + mm_right.sclen_right -
                           (int64_t)an.seg_end[e];
            if ((diff < 0 ? -diff : diff) <= BPRES) {
                int32_t u = an.seg_uid[e];
                if (u < 0) continue;
                for (int64_t t = an.uid_tid_off[u]; t < an.uid_tid_off[u + 1];
                     ++t)
                    out.emplace_back((int)an.uid_tid[t], (int)diff);
            }
        }
        --ind;
    }
}

inline void collect_bp_tids_start(CircCtx& C, const MM& mm_left,
                                  std::vector<std::pair<int, int>>& out) {
    out.clear();
    const Anno& an = *C.an;
    int32_t ind = mm_left.exon_ind_spos;
    while (ind >= 0 && ind < an.n_iv &&
           mm_left.epos > (int64_t)an.iv_spos[ind]) {
        for (int64_t e = an.iv_seg_off[ind]; e < an.iv_seg_off[ind + 1];
             ++e) {
            int64_t diff = mm_left.spos - mm_left.sclen_left -
                           (int64_t)an.seg_start[e];
            if ((diff < 0 ? -diff : diff) <= BPRES) {
                int32_t u = an.seg_uid[e];
                if (u < 0) continue;
                for (int64_t t = an.uid_tid_off[u]; t < an.uid_tid_off[u + 1];
                     ++t)
                    out.emplace_back((int)an.uid_tid[t], (int)diff);
            }
        }
        ++ind;
    }
}

// pipeline/circ.py split_realignment (process_circ.cpp:1343-1392)
inline int split_realignment_c(CircCtx& C, int qcutpos, int64_t beg_bp,
                               int64_t end_bp, const int8_t* seq,
                               int seq_len,
                               const std::vector<int32_t>& common_tid) {
    const Cfg& cfg = C.cfg;
    if (qcutpos <= 0 || qcutpos >= seq_len) return cfg.max_ed + 1;
    const int8_t* last_bp = C.g.get(end_bp, 1);
    int last_err = (last_bp && seq[qcutpos - 1] == last_bp[0]) ? 0 : 1;
    const int8_t* first_bp = C.g.get(beg_bp, 1);
    int first_err = (first_bp && seq[qcutpos] == first_bp[0]) ? 0 : 1;

    AR best_left(beg_bp);
    AR best_right(end_bp);
    int64_t lpos = end_bp, rpos = beg_bp;
    bool lok = C.ex.extend_left_e(common_tid, seq, lpos, qcutpos - 1,
                                  cfg.max_ed - last_err, beg_bp, best_left);
    bool rok = C.ex.extend_right_e(common_tid, seq + qcutpos + 1, rpos,
                                   seq_len - qcutpos - 1,
                                   cfg.max_ed - first_err, end_bp,
                                   best_right);
    best_left.ed += last_err;
    best_right.ed += first_err;
    if (lok && rok && best_left.ed + best_right.ed <= cfg.max_ed)
        return best_left.ed + best_right.ed;
    return cfg.max_ed + 1;
}

int final_check_c(CircCtx& C, MM& full_mm, MM& split_mm_left,
                  MM& split_mm_right, CRes& cr);

// pipeline/circ.py split_realignment_full (process_circ.cpp:1394-1489)
int check_split_map_double_c(CircCtx& C, MM& mm_r1_1, MM& mm_r2_1,
                             MM& mm_r1_2, MM& mm_r2_2, CRes& cr);

inline int split_realignment_full_c(CircCtx& C, int qcutpos, MM& full_mm,
                                    MM& split_mm_left, MM& split_mm_right,
                                    CRes& cr) {
    const Cfg& cfg = C.cfg;
    if (qcutpos <= 0 || qcutpos >= C.fullmap_len) return C_UD;
    qcutpos += full_mm.qspos - 1;
    if (qcutpos <= 0 || qcutpos >= C.fullmap_len) return C_UD;
    overlap_to_spos(split_mm_left, *C.an);
    overlap_to_epos(split_mm_left, *C.an);
    overlap_to_spos(split_mm_right, *C.an);
    overlap_to_epos(split_mm_right, *C.an);
    MM* segs[2] = {&split_mm_left, &split_mm_right};
    std::vector<int32_t> common;
    same_transcript_multi_c(*C.an, segs, 2, common);
    if (common.empty()) return C_UD;
    const int8_t* lbp = C.g.get(split_mm_left.epos, 1);
    int last_err = (lbp && C.fullmap_seq[qcutpos - 1] == lbp[0]) ? 0 : 1;
    const int8_t* fbp = C.g.get(split_mm_right.spos, 1);
    int first_err = (fbp && C.fullmap_seq[qcutpos] == fbp[0]) ? 0 : 1;
    AR best_left(split_mm_right.spos);
    AR best_right(split_mm_left.epos);
    int64_t lm_pos = split_mm_left.epos;
    int64_t rm_pos = split_mm_right.spos;
    bool lok = C.ex.extend_left_e(common, C.fullmap_seq, lm_pos,
                                  qcutpos - 1, cfg.max_ed - last_err,
                                  split_mm_right.spos, best_left);
    bool rok = C.ex.extend_right_e(common, C.fullmap_seq + qcutpos + 1,
                                   rm_pos, C.fullmap_len - qcutpos - 1,
                                   cfg.max_ed - first_err,
                                   split_mm_left.epos, best_right);
    best_left.ed += last_err;
    best_right.ed += first_err;
    if (!lok || !rok || best_left.ed + best_right.ed > cfg.max_ed)
        return C_UD;
    MM nsl;
    nsl.spos = lm_pos;
    nsl.epos = split_mm_left.epos;
    nsl.qspos = best_left.sclen;
    nsl.qepos = qcutpos;
    nsl.dir = full_mm.dir;
    nsl.matched_len = qcutpos - best_left.sclen;
    nsl.sclen_left = best_left.sclen;
    nsl.sclen_right = 0;
    nsl.left_ed = best_left.ed;
    nsl.right_ed = 0;
    nsl.middle_ed = 0;
    nsl.left_ok = true;
    nsl.right_ok = true;
    MM nsr;
    nsr.spos = split_mm_right.spos;
    nsr.epos = rm_pos;
    nsr.qspos = qcutpos + 1;
    nsr.qepos = C.fullmap_len - best_right.sclen;
    nsr.dir = full_mm.dir;
    nsr.matched_len = C.fullmap_len - qcutpos - best_right.sclen;
    nsr.sclen_left = 0;
    nsr.sclen_right = best_right.sclen;
    nsr.left_ed = 0;
    nsr.right_ed = best_right.ed;
    nsr.middle_ed = 0;
    nsr.left_ok = true;
    nsr.right_ok = true;
    C.r1_seq = C.remain_seq; C.r1_len = C.remain_len_q;
    C.r2_seq = C.fullmap_seq; C.r2_len = C.fullmap_len;
    return check_split_map_double_c(C, split_mm_right, nsr, split_mm_left,
                                    nsl, cr);
}

// pipeline/circ.py rescue_overlapping_bsj (process_circ.cpp:1491-1552)
inline int rescue_overlapping_bsj_c(CircCtx& C, MM& full_mm,
                                    MM& split_mm_left, MM& split_mm_right,
                                    CRes& cr) {
    if (full_mm.spos < split_mm_right.spos &&
        split_mm_right.spos <= full_mm.epos) {
        get_junctions_c(*C.an, full_mm);
        int qcut = 0;
        for (const JuncI& ji : full_mm.junc_info)
            if (ji.end == split_mm_right.spos) qcut = ji.bp_matched;
        if (qcut == 0)
            qcut = (int)(split_mm_right.spos - full_mm.spos);
        if (split_realignment_full_c(C, qcut, full_mm, split_mm_left,
                                     split_mm_right, cr) == C_CR)
            return C_CR;
    }
    if (full_mm.spos <= split_mm_left.epos &&
        split_mm_left.epos < full_mm.epos) {
        get_junctions_c(*C.an, full_mm);
        int qcut = 0;
        for (const JuncI& ji : full_mm.junc_info)
            if (ji.beg == split_mm_left.epos) qcut = ji.bp_matched;
        if (qcut == 0)
            qcut = full_mm.matched_len -
                   (int)(full_mm.epos - split_mm_left.epos);
        if (split_realignment_full_c(C, qcut, full_mm, split_mm_left,
                                     split_mm_right, cr) == C_CR)
            return C_CR;
    }
    return C_UD;
}

// pipeline/circ.py final_check (process_circ.cpp:1136-1341)
int final_check_c(CircCtx& C, MM& full_mm, MM& split_mm_left,
                  MM& split_mm_right, CRes& cr) {
    const Cfg& cfg = C.cfg;
    char b1[3], b2[3], b3[3];
    if (split_mm_left.epos < split_mm_right.spos) {
        if (full_mm.dir == 1) {
            if (full_mm.spos <= split_mm_left.spos) return C_FR;
            if (full_mm.epos >= split_mm_right.epos) return C_RF;
        }
        if (full_mm.dir == -1) {
            if (full_mm.epos >= split_mm_right.epos) return C_FR;
            if (full_mm.spos <= split_mm_left.spos) return C_RF;
        }
    } else if (split_mm_right.spos <= split_mm_left.spos &&
               split_mm_left.epos >= split_mm_right.epos) {
        // back-splice geometry (short circRNA allowed)
        if (full_mm.spos < split_mm_right.spos) {
            int64_t off = split_mm_right.spos - full_mm.spos;
            int64_t sc_rem = cfg.max_sc - full_mm.sclen_left;
            if (off <= sc_rem) {
                full_mm.spos = split_mm_right.spos;
                full_mm.sclen_left += (int)off;
                full_mm.qspos += (int)off;
                full_mm.matched_len -= (int)off;
            }
        }
        if (full_mm.epos > split_mm_left.epos) {
            int64_t off = full_mm.epos - split_mm_left.epos;
            int64_t sc_rem = cfg.max_sc - full_mm.sclen_right;
            if (off <= sc_rem) {
                full_mm.epos = split_mm_left.epos;
                full_mm.sclen_right += (int)off;
                full_mm.qepos -= (int)off;
                full_mm.matched_len -= (int)off;
            }
        }
        if (full_mm.spos >= split_mm_right.spos &&
            full_mm.epos <= split_mm_left.epos) {
            const Anno& an = *C.an;
            overlap_to_spos(full_mm, an);
            overlap_to_epos(full_mm, an);
            overlap_to_spos(split_mm_right, an);
            overlap_to_epos(split_mm_right, an);
            overlap_to_spos(split_mm_left, an);
            overlap_to_epos(split_mm_left, an);

            std::vector<std::pair<int, int>> end_tids, start_tids;
            collect_bp_tids_end(C, split_mm_left, end_tids);
            collect_bp_tids_start(C, split_mm_right, start_tids);

            int best_ed = cfg.max_ed + 1;
            std::vector<int32_t> common(1);
            for (auto& st : start_tids) {
                for (auto& et : end_tids) {
                    if (st.first != et.first || st.second != et.second)
                        continue;
                    common[0] = st.first;
                    int sdiff = st.second, ediff = et.second;
                    int qcut = split_mm_left.qepos +
                               split_mm_left.sclen_right - ediff;
                    int64_t beg_bp = split_mm_right.spos -
                                     split_mm_right.sclen_left - sdiff;
                    int64_t end_bp = split_mm_left.epos +
                                     split_mm_left.sclen_right - ediff;

                    if (full_mm.sclen_right > 0) {
                        if (full_mm.epos + full_mm.sclen_right > end_bp) {
                            int fm_qcut = full_mm.qepos +
                                          (int)(end_bp - full_mm.epos);
                            int fm_ed = split_realignment_c(
                                C, fm_qcut, beg_bp, end_bp, C.fullmap_seq,
                                C.fullmap_len, common);
                            if (fm_ed > cfg.max_ed) continue;
                        } else if (full_mm.sclen_right > cfg.max_sc) {
                            continue;
                        }
                    }
                    if (full_mm.sclen_left > 0) {
                        if (full_mm.spos - full_mm.sclen_left < beg_bp) {
                            int fm_qcut = full_mm.sclen_left +
                                          (int)(full_mm.spos - beg_bp);
                            int fm_ed = split_realignment_c(
                                C, fm_qcut, beg_bp, end_bp, C.fullmap_seq,
                                C.fullmap_len, common);
                            if (fm_ed > cfg.max_ed) continue;
                        } else if (full_mm.sclen_left > cfg.max_sc) {
                            continue;
                        }
                    }

                    int ed = split_realignment_c(C, qcut, beg_bp, end_bp,
                                                 C.remain_seq,
                                                 C.remain_len_q, common);
                    if (ed < best_ed) {
                        // numpy slice semantics: qcut < 2 -> empty;
                        // qcut + 2 > len -> partial tail
                        char ss[3] = {0, 0, 0}, es[3] = {0, 0, 0};
                        if (qcut >= 2) {
                            es[0] = code2char(C.remain_seq[qcut - 2]);
                            es[1] = code2char(C.remain_seq[qcut - 1]);
                            if (qcut < C.remain_len_q)
                                ss[0] = code2char(C.remain_seq[qcut]);
                            if (qcut + 1 < C.remain_len_q)
                                ss[1] = code2char(C.remain_seq[qcut + 1]);
                        }
                        cr_set_c(cr, beg_bp, end_bp, ss, es,
                                 C.pac2(beg_bp, b1), C.pac2(end_bp - 1, b2));
                        if (ed == 0) return C_CR;
                        best_ed = ed;
                    }
                }
            }
            if (best_ed <= cfg.max_ed) return C_CR;
            int qcut = split_mm_left.qepos + split_mm_left.sclen_right;
            int64_t beg_bp = split_mm_right.spos - split_mm_right.sclen_left;
            int64_t end_bp = split_mm_left.epos + split_mm_left.sclen_right;
            if (qcut < 2 || qcut > C.remain_len_q - 2) return C_MCR;
            char s[5];
            for (int i = 0; i < 4; ++i)
                s[i] = code2char(C.remain_seq[qcut - 2 + i]);
            s[4] = 0;
            char ss[3] = {s[0], s[1], 0};
            char es[3] = {s[2], s[3], 0};
            cr_set_c(cr, beg_bp, end_bp, ss, es,
                     C.pac2(beg_bp, b1), C.pac2(end_bp - 1, b2));
            (void)b3;
            if (!start_tids.empty() && !end_tids.empty()) return C_NCR;
            return C_MCR;
        }
    }
    return rescue_overlapping_bsj_c(C, full_mm, split_mm_left,
                                    split_mm_right, cr);
}

// pipeline/circ.py check_split_map_single (process_circ.cpp:892-920)
inline int check_split_map_single_c(CircCtx& C, MM& mm_r1, MM& mm_r2,
                                    MM& pm, bool r1_partial, CRes& cr) {
    int valid;
    int split_ed;
    if (r1_partial) {
        split_ed = mm_r1.right_ed + mm_r1.left_ed + mm_r1.middle_ed +
                   pm.right_ed + pm.left_ed + pm.middle_ed;
        if (mm_r1.qspos < pm.qspos)
            valid = final_check_c(C, mm_r2, mm_r1, pm, cr);
        else
            valid = final_check_c(C, mm_r2, pm, mm_r1, cr);
    } else {
        split_ed = mm_r2.right_ed + mm_r2.left_ed + mm_r2.middle_ed +
                   pm.right_ed + pm.left_ed + pm.middle_ed;
        if (mm_r2.qspos < pm.qspos)
            valid = final_check_c(C, mm_r1, mm_r2, pm, cr);
        else
            valid = final_check_c(C, mm_r1, pm, mm_r2, cr);
    }
    if (split_ed > C.cfg.max_ed) valid = C_UD;
    return valid;
}

// pipeline/circ.py check_split_map_double (process_circ.cpp:922-1130)
int check_split_map_double_c(CircCtx& C, MM& mm_r1_1, MM& mm_r2_1,
                             MM& mm_r1_2, MM& mm_r2_2, CRes& cr) {
    const Cfg& cfg = C.cfg;
    char b1[3], b2[3];
    int r1_ed = mm_r1_1.right_ed + mm_r1_1.left_ed + mm_r1_1.middle_ed +
                mm_r1_2.right_ed + mm_r1_2.left_ed + mm_r1_2.middle_ed;
    int r2_ed = mm_r2_1.right_ed + mm_r2_1.left_ed + mm_r2_1.middle_ed +
                mm_r2_2.right_ed + mm_r2_2.left_ed + mm_r2_2.middle_ed;
    if (r1_ed > cfg.max_ed || r2_ed > cfg.max_ed) return C_UD;
    MM& mm_r1_l = (mm_r1_1.spos <= mm_r1_2.spos) ? mm_r1_1 : mm_r1_2;
    MM& mm_r1_r = (mm_r1_1.spos <= mm_r1_2.spos) ? mm_r1_2 : mm_r1_1;
    MM& mm_r2_l = (mm_r2_1.spos <= mm_r2_2.spos) ? mm_r2_1 : mm_r2_2;
    MM& mm_r2_r = (mm_r2_1.spos <= mm_r2_2.spos) ? mm_r2_2 : mm_r2_1;
    bool r1_reg = mm_r1_l.qspos < mm_r1_r.qspos;
    bool r2_reg = mm_r2_l.qspos < mm_r2_r.qspos;

    if (r1_reg && r2_reg) {
        if (mm_r1_l.dir == 1) {
            if (mm_r1_r.spos <= mm_r2_l.spos) return C_FR;
            if (mm_r1_l.epos >= mm_r2_r.epos) return C_RF;
        }
        if (mm_r1_l.dir == -1) {
            if (mm_r2_r.spos <= mm_r1_l.spos) return C_FR;
            if (mm_r2_l.epos >= mm_r1_r.epos) return C_RF;
        }
    } else if (r1_reg && !r2_reg) {
        MM full_mm = mm_r1_l;  // copy (circ.py _copy_mm)
        if (!merge_to_right_c(full_mm, mm_r1_r, cfg.max_ed)) return C_UD;
        C.remain_seq = C.r2_seq; C.remain_len_q = C.r2_len;
        return final_check_c(C, full_mm, mm_r2_l, mm_r2_r, cr);
    } else if (!r1_reg && r2_reg) {
        MM full_mm = mm_r2_l;
        if (!merge_to_right_c(full_mm, mm_r2_r, cfg.max_ed)) return C_UD;
        C.remain_seq = C.r1_seq; C.remain_len_q = C.r1_len;
        return final_check_c(C, full_mm, mm_r1_l, mm_r1_r, cr);
    } else {
        // BSJ on the overlap (process_circ.cpp:989-1127)
        if (mm_r1_l.spos == mm_r2_l.spos && mm_r1_r.epos == mm_r2_r.epos) {
            overlap_to_spos(mm_r1_l, *C.an);
            overlap_to_epos(mm_r1_r, *C.an);
            std::vector<std::pair<int, int>> end_tids, start_tids;
            collect_bp_tids_end(C, mm_r1_r, end_tids);
            collect_bp_tids_start(C, mm_r1_l, start_tids);
            int best_ed1 = cfg.max_ed + 1;
            int best_ed2 = cfg.max_ed + 1;
            std::vector<int32_t> common(1);
            for (auto& st : start_tids) {
                for (auto& et : end_tids) {
                    if (st.first != et.first || st.second != et.second)
                        continue;
                    common[0] = st.first;
                    int sdiff = st.second, ediff = et.second;
                    int64_t beg_bp = mm_r1_l.spos - mm_r1_l.sclen_left -
                                     sdiff;
                    int64_t end_bp = mm_r1_r.epos + mm_r1_r.sclen_right -
                                     ediff;
                    int qcut = mm_r1_r.qepos + mm_r1_r.sclen_right - ediff;
                    int ed1 = split_realignment_c(C, qcut, beg_bp, end_bp,
                                                  C.r1_seq, C.r1_len,
                                                  common);
                    char es1[3] = {0, 0, 0}, ss1[3] = {0, 0, 0};
                    if (!(qcut < 2 || qcut + 2 > C.r1_len)) {
                        es1[0] = code2char(C.r1_seq[qcut - 2]);
                        es1[1] = code2char(C.r1_seq[qcut - 1]);
                        ss1[0] = code2char(C.r1_seq[qcut]);
                        ss1[1] = code2char(C.r1_seq[qcut + 1]);
                    }
                    int qcut2 = mm_r2_r.qepos + mm_r2_r.sclen_right - ediff;
                    int ed2 = split_realignment_c(C, qcut2, beg_bp, end_bp,
                                                  C.r2_seq, C.r2_len,
                                                  common);
                    char es2[3] = {0, 0, 0}, ss2[3] = {0, 0, 0};
                    if (!(qcut2 < 2 || qcut2 + 2 > C.r2_len)) {
                        es2[0] = code2char(C.r2_seq[qcut2 - 2]);
                        es2[1] = code2char(C.r2_seq[qcut2 - 1]);
                        ss2[0] = code2char(C.r2_seq[qcut2]);
                        ss2[1] = code2char(C.r2_seq[qcut2 + 1]);
                    }
                    if (ed1 < best_ed1 && ed2 < best_ed2) {
                        C.pac2(beg_bp, b1);
                        C.pac2(end_bp - 1, b2);
                        if (ss1[0] == 0) {
                            cr_set_c(cr, beg_bp, end_bp, ss2, es2, b1, b2);
                        } else if (ss2[0] == 0) {
                            cr_set_c(cr, beg_bp, end_bp, ss1, es1, b1, b2);
                        } else {
                            char cs[3], ce[3];
                            consensus2c(ss1, ss2, cs);
                            consensus2c(es1, es2, ce);
                            cs[2] = ce[2] = 0;
                            cr_set_c(cr, beg_bp, end_bp, cs, ce, b1, b2);
                        }
                        best_ed1 = ed1;
                        best_ed2 = ed2;
                    }
                }
            }
            if (best_ed1 <= cfg.max_ed && best_ed2 <= cfg.max_ed)
                return C_CR;
            int qcut = mm_r1_r.qepos + mm_r1_r.sclen_right;
            int64_t beg_bp = mm_r1_l.spos - mm_r1_l.sclen_left;
            int64_t end_bp = mm_r1_r.epos + mm_r1_r.sclen_right;
            if (qcut < 2 || qcut > C.r1_len - 2 || qcut > C.r2_len - 2)
                return C_MCR;
            char s1[5], s2[5];
            for (int i = 0; i < 4; ++i) {
                s1[i] = code2char(C.r1_seq[qcut - 2 + i]);
                s2[i] = code2char(C.r2_seq[qcut - 2 + i]);
            }
            char s1h[3] = {s1[0], s1[1], 0}, s1t[3] = {s1[2], s1[3], 0};
            char s2h[3] = {s2[0], s2[1], 0}, s2t[3] = {s2[2], s2[3], 0};
            char cs[3], ce[3];
            consensus2c(s1t, s2t, cs);
            consensus2c(s1h, s2h, ce);
            cs[2] = ce[2] = 0;
            cr_set_c(cr, beg_bp, end_bp, cs, ce,
                     C.pac2(beg_bp, b1), C.pac2(end_bp - 1, b2));
            if (!start_tids.empty() && !end_tids.empty()) return C_NCR;
            return C_MCR;
        }
    }
    return C_UD;
}

// circ-stage view of one conloc'd MatchedRead row (mr_state layout,
// filter_kernels.cpp:1554-1557)
struct MRRow {
    int type;
    int64_t spos_r1, epos_r1, spos_r2, epos_r2;
    int qspos_r1, qepos_r1, qspos_r2, qepos_r2;
    int mlen_r1, mlen_r2, ed_r1, ed_r2;
    bool r1_forward, r2_forward;

    static MRRow load(const int64_t* st) {
        MRRow m;
        m.type = (int)st[0];
        m.spos_r1 = st[1]; m.epos_r1 = st[2];
        m.qspos_r1 = (int)st[3]; m.qepos_r1 = (int)st[4];
        m.mlen_r1 = (int)st[5]; m.ed_r1 = (int)st[6];
        m.r1_forward = st[7] != 0;
        m.spos_r2 = st[8]; m.epos_r2 = st[9];
        m.qspos_r2 = (int)st[10]; m.qepos_r2 = (int)st[11];
        m.mlen_r2 = (int)st[12]; m.ed_r2 = (int)st[13];
        m.r2_forward = st[14] != 0;
        return m;
    }

    // types.py MatchedMate.from_matched_read (common.cpp:192-235)
    MM to_mm(int r1_2, int rlen, bool partial) const {
        MM mm;
        mm.type = type;
        mm.right_ed = 0;
        mm.left_ed = 0;
        if (r1_2 == 1) {
            mm.spos = spos_r1; mm.epos = epos_r1;
            mm.qspos = qspos_r1; mm.qepos = qepos_r1;
            mm.middle_ed = ed_r1;
            mm.matched_len = mlen_r1;
            mm.dir = r1_forward ? 1 : -1;
        } else {
            mm.spos = spos_r2; mm.epos = epos_r2;
            mm.qspos = qspos_r2; mm.qepos = qepos_r2;
            mm.middle_ed = ed_r2;
            mm.matched_len = mlen_r2;
            mm.dir = r2_forward ? 1 : -1;
        }
        if (partial) {
            if ((mm.qspos - 1) > (rlen - mm.qepos)) {
                mm.sclen_left = 0;
                mm.sclen_right = rlen - mm.qepos;
            } else {
                mm.sclen_left = mm.qspos - 1;
                mm.sclen_right = 0;
            }
        } else {
            mm.sclen_left = mm.qspos - 1;
            mm.sclen_right = rlen - mm.qepos;
        }
        return mm;
    }
};

// one read's sequence pointers (orientation-major [4, L] block)
struct ReadSeqs {
    const int8_t *r1f, *r1rc, *r2f, *r2rc;
    int r1_len, r2_len;
};

// pipeline/circ.py call_circ_single_split (process_circ.cpp:346-460)
void call_circ_single_split_c(CircCtx& C, const MRRow& mr,
                              const ReadSeqs& rs) {
    const Cfg& cfg = C.cfg;
    bool r1_partial = mr.mlen_r1 < mr.mlen_r2;
    const int8_t* remain;
    const int8_t* fullm;
    if (r1_partial) {
        remain = mr.r1_forward ? rs.r1f : rs.r1rc;
        fullm = mr.r2_forward ? rs.r2f : rs.r2rc;
        C.remain_len_q = rs.r1_len;
        C.fullmap_len = rs.r2_len;
    } else {
        remain = mr.r2_forward ? rs.r2f : rs.r2rc;
        fullm = mr.r1_forward ? rs.r1f : rs.r1rc;
        C.remain_len_q = rs.r2_len;
        C.fullmap_len = rs.r1_len;
    }
    C.remain_seq = remain;
    C.fullmap_seq = fullm;

    MM mm_r1 = mr.to_mm(1, rs.r1_len, r1_partial);
    MM mm_r2 = mr.to_mm(2, rs.r2_len, !r1_partial);
    int qspos, qepos, whole_len;
    if (r1_partial) {
        bool right_matched = (mm_r1.qspos - 1) > (rs.r1_len - mm_r1.qepos);
        qspos = right_matched ? 1 : mm_r1.qepos + 1;
        qepos = right_matched ? (mm_r1.qspos - 1) : rs.r1_len;
        whole_len = rs.r1_len;
    } else {
        bool right_matched = (mm_r2.qspos - 1) > (rs.r2_len - mm_r2.qepos);
        qspos = right_matched ? 1 : mm_r2.qepos + 1;
        qepos = right_matched ? (mm_r2.qspos - 1) : rs.r2_len;
        whole_len = rs.r2_len;
    }
    int remain_len = qepos - qspos + 1;
    if (qepos < qspos || remain_len < C.w) return;
    int32_t gene_iv = C.gv->gene_overlap(mm_r1.spos);
    if (gene_iv < 0) return;

    CRes best_cr;
    // h_remain: hashes of the full remain read
    const int total_len = C.remain_len_q;
    const int64_t hlen = (int64_t)total_len - C.w + 1;
    C.hbuf.assign(hlen > 0 ? hlen : 0, -1);
    if (hlen > 0)
        RegionalHT::rolling(remain, total_len, C.w, C.hbuf.data());

    bool forward = r1_partial ? mr.r1_forward : mr.r2_forward;
    int direction = forward ? 1 : -1;
    std::vector<ChainV> chains;
    for (int64_t e = C.gv->gv_seg_off[gene_iv];
         e < C.gv->gv_seg_off[gene_iv + 1]; ++e) {
        int64_t gs = (int64_t)C.gv->gv_gene_start[e];
        int64_t ge = (int64_t)C.gv->gv_gene_end[e];
        int32_t gid = C.gv->gv_gene_id[e];
        RegionalHT& ht = C.get_ht(gs, ge, gid);
        circ_chaining(C, qspos, qepos, ht, remain, total_len, gs, chains);
        if (chains.empty()) continue;
        int n_try = std::min((int)chains.size(), TOPCHAIN);
        for (int ci = 0; ci < n_try; ++ci) {
            MM pm = MM::dflt(cfg.max_ed);
            find_exact_coord_c(C, mm_r1, mm_r2, pm, direction, qspos,
                               remain, remain_len, whole_len, chains[ci]);
            if (pm.type != CONCRD) continue;
            int chr_i = C.shifts.find(mm_r1.spos);
            int64_t sh = C.shifts.shift[chr_i];
            CRes cr;
            int typ = check_split_map_single_c(C, mm_r1, mm_r2, pm,
                                               r1_partial, cr);
            C.emit_cand_single(chr_i, sh, pm, mm_r1, mm_r2, typ);
            if (typ < C_CR) {
                best_cr.type = typ;
                return;
            }
            if (C_CR <= typ && typ <= C_MCR && typ < best_cr.type) {
                best_cr = cr;
                best_cr.type = typ;
                best_cr.chr_idx = chr_i;
                best_cr.spos = cr.spos - sh;
                best_cr.epos = cr.epos - sh;
                if (typ == C_CR) {
                    C.emit_res(best_cr);
                    return;
                }
            }
        }
    }
    if (C_CR <= best_cr.type && best_cr.type <= C_MCR)
        C.emit_res(best_cr);
}

// pipeline/circ.py call_circ_double_split (process_circ.cpp:462-645)
void call_circ_double_split_c(CircCtx& C, const MRRow& mr,
                              const ReadSeqs& rs) {
    const Cfg& cfg = C.cfg;
    const int8_t* r1_remain = mr.r1_forward ? rs.r1f : rs.r1rc;
    const int8_t* r2_remain = mr.r2_forward ? rs.r2f : rs.r2rc;
    C.r1_seq = r1_remain; C.r2_seq = r2_remain;
    C.r1_len = rs.r1_len; C.r2_len = rs.r2_len;

    bool r1_right = (mr.qspos_r1 - 1) > (rs.r1_len - mr.qepos_r1);
    bool r2_right = (mr.qspos_r2 - 1) > (rs.r2_len - mr.qepos_r2);
    int r1_qspos = r1_right ? 1 : mr.qepos_r1 + 1;
    int r2_qspos = r2_right ? 1 : mr.qepos_r2 + 1;
    int r1_qepos = r1_right ? (mr.qspos_r1 - 1) : rs.r1_len;
    int r2_qepos = r2_right ? (mr.qspos_r2 - 1) : rs.r2_len;
    int r1_len = r1_qepos - r1_qspos + 1;
    int r2_len = r2_qepos - r2_qspos + 1;
    if (r1_len < C.w && r2_len < C.w) return;
    if (r1_len < C.w || r2_len < C.w)
        call_circ_single_split_c(C, mr, rs);
    int32_t gene_iv = C.gv->gene_overlap(mr.spos_r1);
    if (gene_iv < 0) return;
    MM mm_r1 = mr.to_mm(1, rs.r1_len, true);
    MM mm_r2 = mr.to_mm(2, rs.r2_len, true);
    CRes best_cr;

    // hashes of both remain reads
    std::vector<int32_t> h1, h2;
    const int64_t h1len = (int64_t)rs.r1_len - C.w + 1;
    const int64_t h2len = (int64_t)rs.r2_len - C.w + 1;
    h1.assign(h1len > 0 ? h1len : 0, -1);
    h2.assign(h2len > 0 ? h2len : 0, -1);
    if (h1len > 0) RegionalHT::rolling(r1_remain, rs.r1_len, C.w, h1.data());
    if (h2len > 0) RegionalHT::rolling(r2_remain, rs.r2_len, C.w, h2.data());

    std::vector<ChainV> bc1, bc2;
    // the chain views point into ctx buffers that are reused per chaining
    // call — bc1's data must survive the bc2 call, so keep private copies
    std::vector<int32_t> bc1_rpos, bc1_qpos, bc1_clen;
    std::vector<double> bc1_score;
    for (int64_t e = C.gv->gv_seg_off[gene_iv];
         e < C.gv->gv_seg_off[gene_iv + 1]; ++e) {
        int64_t gs = (int64_t)C.gv->gv_gene_start[e];
        int64_t ge = (int64_t)C.gv->gv_gene_end[e];
        int32_t gid = C.gv->gv_gene_id[e];
        RegionalHT& ht = C.get_ht(gs, ge, gid);
        C.hbuf = h1;
        circ_chaining(C, r1_qspos, r1_qepos, ht, r1_remain, rs.r1_len, gs,
                      bc1);
        // deep-copy bc1 storage before the second chaining reuses buffers
        int NL1 = 0;
        if (!bc1.empty()) {
            NL1 = (int)(C.o_rpos.size() / C.o_clen.size());
            bc1_rpos = C.o_rpos; bc1_qpos = C.o_qpos;
            bc1_clen = C.o_clen; bc1_score = C.o_score;
            for (size_t i = 0; i < bc1.size(); ++i) {
                bc1[i].rpos = bc1_rpos.data() + i * NL1;
                bc1[i].qpos = bc1_qpos.data() + i * NL1;
            }
        }
        C.hbuf = h2;
        circ_chaining(C, r2_qspos, r2_qepos, ht, r2_remain, rs.r2_len, gs,
                      bc2);
        if (bc1.empty() && bc2.empty()) continue;
        if (bc1.empty() || bc2.empty()) {
            call_circ_single_split_c(C, mr, rs);
            continue;
        }
        int n1 = std::min((int)bc1.size(), TOPCHAIN);
        int n2 = std::min((int)bc2.size(), TOPCHAIN);
        for (int i1 = 0; i1 < n1; ++i1) {
            for (int i2 = 0; i2 < n2; ++i2) {
                const ChainV& ch1 = bc1[i1];
                const ChainV& ch2 = bc2[i2];
                MM r1_pm = MM::dflt(cfg.max_ed);
                MM r2_pm = MM::dflt(cfg.max_ed);
                set_mm_c(ch1, r1_qspos, r1_len, mm_r1.dir, r1_pm);
                set_mm_c(ch2, r2_qspos, r2_len, mm_r2.dir, r2_pm);
                overlap_to_spos(mm_r1, *C.an);
                overlap_to_spos(mm_r2, *C.an);
                overlap_to_spos(r1_pm, *C.an);
                overlap_to_spos(r2_pm, *C.an);
                MM* segs[4] = {&mm_r1, &mm_r2, &r1_pm, &r2_pm};
                std::vector<int32_t> common;
                same_transcript_multi_c(*C.an, segs, 4, common);
                if (common.empty()) continue;
                bool success;
                if (ch1.r(0) <= ch2.r(0))
                    success = extend_both_mates(
                        C.ex, ch1, ch2, common, r1_remain, r2_remain,
                        r1_qspos, r2_qspos, r1_qepos, r2_qepos, r1_pm,
                        r2_pm);
                else
                    success = extend_both_mates(
                        C.ex, ch2, ch1, common, r2_remain, r1_remain,
                        r2_qspos, r1_qspos, r2_qepos, r1_qepos, r2_pm,
                        r1_pm);
                if (!success) continue;
                if (r1_pm.type == CONCRD && r2_pm.type == CONCRD) {
                    int chr_i = C.shifts.find(mm_r1.spos);
                    int64_t sh = C.shifts.shift[chr_i];
                    CRes cr;
                    int typ = check_split_map_double_c(C, mm_r1, mm_r2,
                                                       r1_pm, r2_pm, cr);
                    C.emit_cand_double(chr_i, sh, r1_pm, r2_pm, mm_r1,
                                       mm_r2, typ);
                    if (typ < C_CR) {
                        best_cr.type = typ;
                        return;
                    }
                    if (C_CR <= typ && typ <= C_MCR && typ < best_cr.type) {
                        best_cr = cr;
                        best_cr.type = typ;
                        best_cr.chr_idx = chr_i;
                        best_cr.spos = cr.spos - sh;
                        best_cr.epos = cr.epos - sh;
                        if (typ == C_CR) {
                            C.emit_res(best_cr);
                            return;
                        }
                    }
                }
            }
        }
    }
    if (C_CR <= best_cr.type && best_cr.type <= C_MCR)
        C.emit_res(best_cr);
    else
        call_circ_single_split_c(C, mr, rs);
}

// pipeline/circ.py call_circ (process_circ.cpp:334-345)
void call_circ_c(CircCtx& C, const MRRow& mr, const ReadSeqs& rs,
                 int64_t evict_pos) {
    C.fullmap_seq = C.remain_seq = nullptr;
    C.r1_seq = C.r2_seq = nullptr;
    C.fullmap_len = C.remain_len_q = 0;
    C.r1_len = 0; C.r2_len = 0;
    C.evict(evict_pos);
    if (mr.type == CHIBSJ)
        call_circ_single_split_c(C, mr, rs);
    else if (mr.type == CHI2BSJ)
        call_circ_double_split_c(C, mr, rs);
}

}  // namespace

extern "C" {

// One call processes the whole position-sorted BSJ stream of a contig.
// seqs: [4*n_reads, L] (r1f, r1rc, r2f, r2rc); lens [4*n_reads];
// mr_state [n_reads, 20] in CONTIG coordinates (the Python caller conlocs);
// evict_pos [n_reads] = raw (chr-relative) spos_r1 — preserves the oracle's
// eviction quirk (circ.py call_circ uses the un-conloc'd position).
// Outputs are tagged record streams (res: RES_W int64 each; cand: CAND_W);
// *res_n / *cand_n return totals NEEDED — when they exceed the caps the
// caller must retry with larger buffers (nothing beyond the cap is
// written).
void batch_circ(
    const int8_t* seqs, const int32_t* lens, int32_t n_reads, int32_t L,
    const int64_t* mr_state, const int64_t* evict_pos,
    const int8_t* genome, int64_t glen,
    // filter annotation (same order as batch_filter_pe)
    const uint32_t* iv_spos, const uint32_t* iv_epos, int32_t n_iv,
    const int64_t* iv_seg_off,
    const uint32_t* seg_start, const uint32_t* seg_end,
    const uint32_t* seg_next, const int32_t* seg_gene,
    const int32_t* seg_uid,
    const int64_t* uid_tid_off, const int32_t* uid_tid,
    const int64_t* t2s_off, const uint8_t* t2s_state,
    const int32_t* trans_start, int32_t n_trans,
    const uint32_t* gene_start, const uint32_t* gene_end,
    const uint8_t* intr_bits, int64_t intr_len,
    const int64_t* shift_vals, int32_t n_shift,
    // chain-DP annotation (ops/chain_native.py arrays)
    const uint8_t* nb, int64_t nb_len,
    const int32_t* c_iv_spos, const int32_t* c_iv_epos,
    const int32_t* c_iv_max_end, const int32_t* c_iv_min_end,
    const int32_t* c_iv_max_next, const int64_t* c_iv_seg_off,
    const int32_t* c_seg_end, const int32_t* c_seg_next, int32_t c_n_iv,
    // gene view (annotation.py gv_* arrays)
    const uint32_t* gv_spos, const uint32_t* gv_epos, int32_t n_gv,
    const int64_t* gv_seg_off, const uint32_t* gv_gene_start,
    const uint32_t* gv_gene_end, const int32_t* gv_gene_id,
    // config
    int32_t kmer, int32_t max_ed, int32_t max_sc, int32_t band,
    int32_t max_tlen, int32_t scan_level, int32_t contig_num,
    int32_t mat, int32_t mis, int32_t ind, int32_t xd,
    int64_t max_intron,
    int32_t circ_window, int32_t circ_step, int32_t seed_lim,
    int32_t max_chain,
    // outputs
    int64_t* out_res, int32_t res_cap, int32_t* res_n,
    int64_t* out_cand, int32_t cand_cap, int32_t* cand_n,
    int32_t n_threads) {

    Anno an;
    an.iv_spos = iv_spos; an.iv_epos = iv_epos; an.n_iv = n_iv;
    an.iv_seg_off = iv_seg_off;
    an.seg_start = seg_start; an.seg_end = seg_end; an.seg_next = seg_next;
    an.seg_gene = seg_gene; an.seg_uid = seg_uid;
    an.uid_tid_off = uid_tid_off; an.uid_tid = uid_tid;
    an.t2s_off = t2s_off; an.t2s_state = t2s_state;
    an.trans_start = trans_start; an.n_trans = n_trans;
    an.gene_start = gene_start; an.gene_end = gene_end;
    an.intr_bits = intr_bits; an.intr_len = intr_len;

    ChainArgs ca{nb, nb_len, c_iv_spos, c_iv_epos, c_iv_max_end,
                 c_iv_min_end, c_iv_max_next, c_iv_seg_off, c_seg_end,
                 c_seg_next, c_n_iv};

    GeneView gv{gv_spos, gv_epos, n_gv, gv_seg_off, gv_gene_start,
                gv_gene_end, gv_gene_id};

    Cfg cfg;
    cfg.kmer = kmer; cfg.max_ed = max_ed; cfg.max_sc = max_sc;
    cfg.band = band; cfg.max_tlen = max_tlen; cfg.scan_level = scan_level;
    cfg.contig_num = contig_num;
    cfg.mat = mat; cfg.mis = mis; cfg.ind = ind; cfg.xd = xd;
    cfg.align_type = 1;  // EDIT_ALIGNMENT (circ.py:136-137)

    int T = n_threads > 0 ? n_threads : 1;
    std::vector<CircCtx> ctxs(T);
    for (int t = 0; t < T; ++t) {
        CircCtx& C = ctxs[t];
        C.an = &an; C.ca = &ca; C.gv = &gv;
        C.cfg = cfg;
        C.g = Genome{genome, glen};
        C.ex.an = &an;
        C.ex.g = C.g;
        C.ex.cfg = cfg;
        C.shifts = ShiftTab{shift_vals, n_shift};
        C.w = circ_window; C.step = circ_step;
        C.seed_lim = seed_lim; C.max_chain = max_chain;
        C.max_intron = max_intron;
    }

    auto worker = [&](int t0) {
        CircCtx& C = ctxs[t0];
        for (int p = t0; p < n_reads; p += T) {
            const int64_t* st = mr_state + (int64_t)p * 20;
            MRRow mr = MRRow::load(st);
            ReadSeqs rs;
            rs.r1f = seqs + (int64_t)(4 * p) * L;
            rs.r1rc = seqs + (int64_t)(4 * p + 1) * L;
            rs.r2f = seqs + (int64_t)(4 * p + 2) * L;
            rs.r2rc = seqs + (int64_t)(4 * p + 3) * L;
            rs.r1_len = lens[4 * p];
            rs.r2_len = lens[4 * p + 2];
            C.read_idx = p;
            call_circ_c(C, mr, rs, evict_pos[p]);
        }
    };
    if (T == 1) {
        worker(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t) ts.emplace_back(worker, t);
        for (auto& th : ts) th.join();
    }

    // merge per-worker streams (Python re-orders stably by read_idx)
    int64_t tot_res = 0, tot_cand = 0;
    for (auto& C : ctxs) {
        tot_res += (int64_t)C.res_out.size() / RES_W;
        tot_cand += (int64_t)C.cand_out.size() / CAND_W;
    }
    *res_n = (int32_t)tot_res;
    *cand_n = (int32_t)tot_cand;
    if (tot_res <= res_cap && tot_cand <= cand_cap) {
        int64_t ro = 0, co = 0;
        for (auto& C : ctxs) {
            std::memcpy(out_res + ro, C.res_out.data(),
                        C.res_out.size() * sizeof(int64_t));
            ro += C.res_out.size();
            std::memcpy(out_cand + co, C.cand_out.data(),
                        C.cand_out.size() * sizeof(int64_t));
            co += C.cand_out.size();
        }
    }
}

}  // extern "C"
