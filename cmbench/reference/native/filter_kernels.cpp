// Native per-read mapping finish engine for circminer-tpu.
//
// Exact port of the Python host orchestration (pipeline/mapping.py,
// pipeline/extend.py, pipeline/categories.py, pipeline/types.py), itself
// modeled on the reference CircMiner's FilterRead / TransExtension / rule
// engine (src/filter.cpp:124-395, src/extend.cpp, src/utils.cpp:22-320,
// src/common.cpp:286-411).  One call maps a whole batch of PE reads —
// taking the chain lists produced by batch_chain (chain_kernels.cpp) —
// across std::thread workers, updating the persistent per-pair MatchedRead
// state in place.
//
// Build: g++ -O3 -shared -fPIC -pthread filter_kernels.cpp -o libfilter.so

#include <cstdint>
#include <algorithm>
#include <array>
#include <cstring>
#include <map>
#include <thread>
#include <vector>

#include "align_kernels.cpp"  // banded DP / x-drop primitives (same .so)

// gene-local re-chaining for the circ stage (same .so; batch_chain becomes
// a plain function in this TU instead of an extern "C" export)
#define CHAIN_KERNELS_INLINE
#include "chain_kernels.cpp"

namespace {

// category lattice (config.py:34-47, common.h:56-72)
constexpr int CONCRD = 0, DISCRD = 1, CHIORF = 2, CHIBSJ = 3, CHI2BSJ = 4,
              CONGEN = 5, CHIFUS = 6, CONGNM = 7, OEA2 = 8, CANDID = 9,
              OEANCH = 10, ORPHAN = 11, NOPROC_MANYHIT = 12,
              NOPROC_NOMATCH = 13;
constexpr int64_t INF = 1000000000;
constexpr int64_t MINLB = 0;
constexpr int64_t MAXUB = 4294967295LL;
constexpr int64_t MAXDISCRDTLEN = 20000;
constexpr int64_t LARIAT2BEGTH = 1000;
constexpr int64_t NEG_INF = -INF;

struct Cfg {
    int kmer, max_ed, max_sc, band, max_tlen, scan_level, contig_num;
    int mat, mis, ind, xd;   // drop-aligner score matrix
    int align_type;          // 0 = drop (mapping), 1 = edit (circ stage)
};

// ---- flat annotation (annotation/annotation.py::ContigAnnotation) ----------
struct Anno {
    const uint32_t *iv_spos, *iv_epos;
    int32_t n_iv;
    const int64_t* iv_seg_off;
    const uint32_t *seg_start, *seg_end, *seg_next;
    const int32_t *seg_gene, *seg_uid;
    const int64_t* uid_tid_off;
    const int32_t* uid_tid;
    const int64_t* t2s_off;
    const uint8_t* t2s_state;
    const int32_t* trans_start;
    int32_t n_trans;
    const uint32_t *gene_start, *gene_end;
    const uint8_t* intr_bits;
    int64_t intr_len;

    bool intronic(int64_t pos) const {
        if (!intr_bits || pos < 0 || pos >= intr_len) return false;
        return (intr_bits[pos >> 3] >> (pos & 7)) & 1;
    }

    // annotation.py find_ind: (found index or -1, raw ind)
    void find_ind(int64_t pos, int32_t* found, int32_t* raw) const {
        if (n_iv == 0 || pos < (int64_t)iv_spos[0]) {
            *found = -1; *raw = -1; return;
        }
        int32_t lo = 0, hi = n_iv;
        while (lo < hi) {
            int32_t mid = (lo + hi) >> 1;
            if ((int64_t)iv_spos[mid] <= pos) lo = mid + 1; else hi = mid;
        }
        int32_t ind = lo - 1;
        *raw = ind;
        *found = (ind >= 0 && (int64_t)iv_epos[ind] >= pos) ? ind : -1;
    }

    // annotation.py get_location_overlap_ind (empty seg list -> not found)
    void overlap_ind(int64_t pos, int32_t* found, int32_t* raw) const {
        find_ind(pos, found, raw);
        if (*found >= 0 && iv_seg_off[*found + 1] == iv_seg_off[*found])
            *found = -1;
    }

    int t2s_len(int tid) const {
        return (int)(t2s_off[tid + 1] - t2s_off[tid]);
    }
    int t2s(int tid, int row) const {
        int64_t size = t2s_off[tid + 1] - t2s_off[tid];
        if (row < 0 || row >= size) return 0;
        return t2s_state[t2s_off[tid] + row];
    }

    // transcript ids over an interval's seg list, reference collection order
    void interval_tids(int32_t iv, std::vector<int32_t>& out) const {
        out.clear();
        if (iv < 0) return;
        for (int64_t e = iv_seg_off[iv]; e < iv_seg_off[iv + 1]; ++e) {
            int32_t u = seg_uid[e];
            if (u < 0) continue;
            for (int64_t t = uid_tid_off[u]; t < uid_tid_off[u + 1]; ++t)
                out.push_back(uid_tid[t]);
        }
    }
};

// ordered intersection (categories.py intersect_trans)
void intersect_tids(const std::vector<int32_t>& a,
                    const std::vector<int32_t>& b,
                    std::vector<int32_t>& out) {
    out.clear();
    for (int32_t t : a)
        if (std::find(b.begin(), b.end(), t) != b.end())
            out.push_back(t);
}

// categories.py same_transcript2
void same_transcript2(const Anno& an, int32_t iv_a, int32_t iv_b,
                      std::vector<int32_t>& out) {
    out.clear();
    if (iv_a < 0 || iv_b < 0) return;
    std::vector<int32_t> ta, tb;
    an.interval_tids(iv_a, ta);
    an.interval_tids(iv_b, tb);
    intersect_tids(ta, tb, out);
}

// categories.py same_gene_iv (utils.cpp:605-615)
bool same_gene_iv(const Anno& an, int32_t iv_a, int32_t iv_b) {
    if (iv_a < 0 || iv_b < 0) return false;
    for (int64_t ea = an.iv_seg_off[iv_a]; ea < an.iv_seg_off[iv_a + 1]; ++ea)
        for (int64_t eb = an.iv_seg_off[iv_b]; eb < an.iv_seg_off[iv_b + 1];
             ++eb)
            if (an.seg_gene[ea] == an.seg_gene[eb]) return true;
    return false;
}

// categories.py same_gene_span (utils.cpp:617-627)
bool same_gene_span(const Anno& an, int32_t iv_mate, int64_t s, int64_t e) {
    if (iv_mate < 0) return false;
    for (int64_t ei = an.iv_seg_off[iv_mate]; ei < an.iv_seg_off[iv_mate + 1];
         ++ei) {
        int32_t g = an.seg_gene[ei];
        if ((int64_t)an.gene_start[g] <= s && e <= (int64_t)an.gene_end[g])
            return true;
    }
    return false;
}

// categories.py _same_exon (UniqSeg::same_exon, common.cpp:128-130)
bool same_exon(const Anno& an, int32_t iv_a, int32_t iv_b) {
    if (iv_a < 0 || iv_b < 0) return false;
    for (int64_t ea = an.iv_seg_off[iv_a]; ea < an.iv_seg_off[iv_a + 1]; ++ea)
        for (int64_t eb = an.iv_seg_off[iv_b]; eb < an.iv_seg_off[iv_b + 1];
             ++eb)
            if (an.seg_start[ea] == an.seg_start[eb] &&
                an.seg_end[ea] == an.seg_end[eb])
                return true;
    return false;
}

// ---- chain view (ops/chain.py::Chain; flen == kmer for every fragment) -----
struct ChainV {
    const int32_t* rpos;
    const int32_t* qpos;
    int len;
    double score;
    int k;
    int64_t r(int i) const { return rpos[i]; }
    int64_t q(int i) const { return qpos[i]; }
    int64_t f(int i) const { (void)i; return k; }
    int64_t rbeg() const { return rpos[0]; }
    int64_t rend() const { return rpos[len - 1] + k - 1; }
};

// categories.py is_left_chain (utils.cpp:827-887)
bool is_left_chain(const ChainV& a, const ChainV& b, int read_length) {
    int64_t a_beg = a.rbeg(), b_beg = b.rbeg();
    int64_t a_end = a.rend(), b_end = b.rend();
    if (b_beg > a_end || a_beg > b_end) return a_beg < b_beg;
    int i = 0, j = 0;
    int64_t best_distance = INF;
    int best_i = -1, best_j = -1;
    while (i < a.len && j < b.len) {
        int64_t bj_beg = b.r(j);
        int64_t ai_end = a.r(i) + a.f(i) - 1;
        if (ai_end < bj_beg) {
            int64_t d = bj_beg - ai_end;
            if (d < best_distance) { best_distance = d; best_i = i; best_j = j; }
            ++i;
            continue;
        }
        int64_t ai_beg = a.r(i);
        int64_t bj_end = b.r(j) + b.f(j) - 1;
        if (bj_end < ai_beg) {
            int64_t d = ai_beg - bj_end;
            if (d < best_distance) { best_distance = d; best_i = i; best_j = j; }
            ++j;
            continue;
        }
        best_i = i; best_j = j;
        break;
    }
    int64_t common_bp = std::max(a.r(best_i), b.r(best_j));
    int64_t a_ov_qpos = a.q(best_i) + (common_bp - a.r(best_i));
    int64_t b_ov_qpos = b.q(best_j) + (common_bp - b.r(best_j));
    if (a_ov_qpos < read_length && b_ov_qpos < read_length)
        return a_ov_qpos >= b_ov_qpos;
    return a_beg < b_beg;
}

// ---- data model (pipeline/types.py; common.h:260-352) ----------------------
// types.py JuncInfo (used by the circ stage's junction rescue)
struct JuncI { int64_t beg, end; int bp_matched; };

struct MM {
    int64_t spos = 0, epos = 0;
    int qspos = 0, qepos = 0;
    int right_ed, left_ed, middle_ed;
    int sclen_right = 0, sclen_left = 0, matched_len = 0;
    int dir = 0, type = ORPHAN, junc_num = 0;
    bool is_concord = false, left_ok = false, right_ok = false;
    bool looked_spos = false, looked_epos = false;
    int32_t exon_ind_spos = -1, exon_ind_epos = -1;
    int32_t exons_spos = -1, exons_epos = -1;  // -1 == None
    std::vector<JuncI> junc_info;              // filled by get_junctions_c

    static MM dflt(int max_ed) {
        MM m;
        m.right_ed = m.left_ed = m.middle_ed = max_ed + 1;
        return m;
    }
    int ed() const { return left_ed + middle_ed + right_ed; }
};

// lazy lookups (categories.py overlap_to_spos/epos; utils.cpp:667-683)
void overlap_to_spos(MM& mm, const Anno& an) {
    if (mm.looked_spos || mm.exons_spos >= 0) return;
    an.overlap_ind(mm.spos, &mm.exons_spos, &mm.exon_ind_spos);
    mm.looked_spos = true;
}
void overlap_to_epos(MM& mm, const Anno& an) {
    if (mm.looked_epos || mm.exons_epos >= 0) return;
    an.overlap_ind(mm.epos, &mm.exons_epos, &mm.exon_ind_epos);
    mm.looked_epos = true;
}

// categories.py same_gene_mm (utils.cpp:629-639)
bool same_gene_mm(const Anno& an, const MM& mm, const MM& other) {
    if (mm.exons_spos < 0) return false;
    return same_gene_span(an, mm.exons_spos, other.spos, other.epos);
}

// persistent per-pair best mapping; field layout mirrors the int64 array the
// Python wrapper passes (ops/filter_native.py MR_FIELDS)
struct MR {
    int type = NOPROC_NOMATCH;
    int64_t spos_r1 = 0, epos_r1 = 0, spos_r2 = 0, epos_r2 = 0;
    int qspos_r1 = 0, qepos_r1 = 0, qspos_r2 = 0, qepos_r2 = 0;
    int mlen_r1 = 0, mlen_r2 = 0;
    int ed_r1, ed_r2;
    bool r1_forward = true, r2_forward = true;
    int64_t tlen = INF;
    int junc_num = 0;
    bool gm_compatible = false;
    int contig_num = 0;
    int chr_idx = -1;

    // types.py go_for_update (common.cpp:362-411)
    bool go_for_update(const MM& r1, const MM& r2, int64_t tl, bool gm,
                       int ty) const {
        if (ty < type) return true;
        if (ty > type) return false;
        if (gm && !gm_compatible) return true;
        if (!gm && gm_compatible) return false;
        int ed = r1.ed() + r2.ed();
        int mlen = r1.matched_len + r2.matched_len;
        if (ty < CHIBSJ) {
            if (ed_r1 + ed_r2 > ed) return true;
            if (ed_r1 + ed_r2 < ed) return false;
            if (tlen > tl) return true;
            if (tlen < tl) return false;
            if (mlen_r1 + mlen_r2 < mlen) return true;
            if (mlen_r1 + mlen_r2 > mlen) return false;
        } else {
            if (mlen_r1 + mlen_r2 < mlen) return true;
            if (mlen_r1 + mlen_r2 > mlen) return false;
            if (ed_r1 + ed_r2 > ed) return true;
            if (ed_r1 + ed_r2 < ed) return false;
        }
        return false;
    }

    // types.py update (common.cpp:286-351)
    bool update(const MM& r1, const MM& r2, int chr_i, int64_t shift,
                int64_t tl, int jun_between, bool gm, int ty, bool r1_first,
                int contig) {
        if (!go_for_update(r1, r2, tl, gm, ty)) return false;
        type = ty;
        chr_idx = chr_i;
        const MM& a = r1_first ? r1 : r2;
        const MM& b = r1_first ? r2 : r1;
        spos_r1 = a.spos - shift; epos_r1 = a.epos - shift;
        qspos_r1 = a.qspos; qepos_r1 = a.qepos;
        mlen_r1 = a.matched_len;
        ed_r1 = a.ed();
        spos_r2 = b.spos - shift; epos_r2 = b.epos - shift;
        qspos_r2 = b.qspos; qepos_r2 = b.qepos;
        mlen_r2 = b.matched_len;
        ed_r2 = b.ed();
        r1_forward = a.dir > 0;
        r2_forward = b.dir > 0;
        tlen = tl;
        junc_num = jun_between + r1.junc_num + r2.junc_num;
        gm_compatible = gm;
        contig_num = contig;
        return true;
    }

    bool update_type(int ty) {
        if (ty < type) { type = ty; return true; }
        return false;
    }
};

// ---- alignment result (extend.py::AlignRes; align.h:12-121) ----------------
struct AR {
    int64_t pos;
    int ed = 0, sclen = 0, indel = 0, qcovlen = 0, rcovlen = 0;
    int64_t score = NEG_INF;

    explicit AR(int64_t p = 0) : pos(p) {}

    void set(int64_t p, int e, int s, int i, int qc, int64_t scr) {
        pos = p; ed = e; sclen = s; indel = i;
        qcovlen = qc; rcovlen = qc - i; score = scr;
    }
    void update(int e, int s, int64_t newpos, int i, int qc, int64_t scr) {
        pos = newpos; ed += e; sclen = s; indel += i;
        qcovlen += qc; rcovlen += qc - i; score = scr;
    }
    bool update_by_score_right(const AR& r) {
        if (score < r.score || (score == r.score && r.pos < pos)) {
            set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score);
            return true;
        }
        return false;
    }
    bool update_by_score_left(const AR& r) {
        if (score < r.score || (score == r.score && r.pos > pos)) {
            set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score);
            return true;
        }
        return false;
    }
    void update_dir(const AR& r, int max_ed, int max_sc, bool right) {
        if (r.qcovlen > qcovlen) {
            int pre_ed = ed;
            if (r.ed <= max_ed && r.sclen <= max_sc &&
                2 * (r.ed - pre_ed) < (r.qcovlen - qcovlen))
                set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score);
        } else if (r.qcovlen < qcovlen) {
            if (r.ed <= max_ed && r.sclen <= max_sc &&
                2 * (ed - r.ed) >= (qcovlen - r.qcovlen))
                set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score);
        } else {
            bool pos_better = right ? (r.pos < pos) : (r.pos > pos);
            if (r.ed < ed || (r.ed == ed && r.sclen < sclen) ||
                (r.ed == ed && r.sclen == sclen && pos_better))
                set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score);
        }
    }
    void update_right(const AR& r, int me, int ms) { update_dir(r, me, ms, true); }
    void update_left(const AR& r, int me, int ms) { update_dir(r, me, ms, false); }
};

// ---- genome access (extend.py::GenomeView; pac2char) ------------------------
struct Genome {
    const int8_t* codes;
    int64_t len;
    // 1-based window [start, start+length-1]; nullptr when out of range
    const int8_t* get(int64_t start, int64_t length) const {
        if (start < 1 || length < 0 || start + length - 1 > len)
            return nullptr;
        return codes + (start - 1);
    }
};

// memo key: (rspos, ref_len, covered, remain_q) (extend.cpp AllCoord)
using MemoKey = std::array<int64_t, 4>;
using Memo = std::map<MemoKey, AR>;

// ---- TransExtension (extend.py; src/extend.cpp) -----------------------------
struct Extender {
    const Anno* an;
    Genome g;
    Cfg cfg;

    // pluggable aligner wrappers (extend.py _local_*):
    // returns via out[4]: ed, sclen, indel, score
    void local_right_sc(const int8_t* s, int n, const int8_t* t, int m,
                        int64_t* out) const {
        if (cfg.align_type == 1)
            edit_local_right_sc(s, n, t, m, cfg.band, cfg.max_ed, cfg.max_sc,
                                out);
        else
            drop_local_right_sc(s, n, t, m, cfg.band, cfg.max_ed, cfg.max_sc,
                                cfg.mat, cfg.mis, cfg.ind, cfg.xd, out);
    }
    void local_left_sc(const int8_t* s, int n, const int8_t* t, int m,
                       int64_t* out) const {
        if (cfg.align_type == 1)
            edit_local_left_sc(s, n, t, m, cfg.band, cfg.max_ed, cfg.max_sc,
                               out);
        else
            drop_local_left_sc(s, n, t, m, cfg.band, cfg.max_ed, cfg.max_sc,
                               cfg.mat, cfg.mis, cfg.ind, cfg.xd, out);
    }
    // returns via out[3]: ed, indel, score
    void loc_right(const int8_t* s, int n, const int8_t* t, int m,
                   int64_t* out) const {
        local_right(s, n, t, m, cfg.band, cfg.max_ed, cfg.max_sc, out);
    }
    void loc_left(const int8_t* s, int n, const int8_t* t, int m,
                  int64_t* out) const {
        local_left(s, n, t, m, cfg.band, cfg.max_ed, cfg.max_sc, out);
    }

    // extend.py calc_middle_ed (extend.cpp:878-920)
    int calc_middle_ed(const ChainV& ch, int edth, const int8_t* qseq,
                       int qseq_len) const {
        (void)qseq_len;
        if (ch.len == 0) return 0;
        int mid_err = 0;
        for (int i = 0; i + 1 < ch.len; ++i) {
            if (ch.q(i + 1) > ch.q(i) + ch.f(i)) {
                int64_t diff = (ch.r(i + 1) - ch.r(i)) -
                               (ch.q(i + 1) - ch.q(i));
                int64_t qspos = ch.q(i) + ch.f(i);
                int64_t qlen = ch.q(i + 1) - qspos;
                int64_t rspos = ch.r(i) + ch.f(i);
                int64_t rlen = std::max(qlen + diff, (int64_t)0);
                if (0 <= diff && diff <= cfg.band) {
                    const int8_t* rseq = g.get(rspos, rlen);
                    int64_t rl = rseq ? rlen : 0;
                    mid_err += (int)one_side_banded(qseq + qspos, (int)qlen,
                                                    rseq, (int)rl, (int)diff);
                } else if (-cfg.band <= diff && diff < 0) {
                    const int8_t* rseq = g.get(rspos, rlen);
                    int64_t rl = rseq ? rlen : 0;
                    mid_err += (int)one_side_banded(rseq, (int)rl,
                                                    qseq + qspos, (int)qlen,
                                                    (int)-diff);
                }
                if (mid_err > edth) return edth + 1;
            }
        }
        return mid_err;
    }

    // extend.py _extend_right_middle (extend.cpp:435-460)
    bool right_middle(int64_t pos, int64_t exon_len, const int8_t* qseq,
                      int seq_remain_cap, int ed_th, AR& best, AR& curr,
                      AR* exon_res) const {
        const int8_t* ref_seq = g.get(pos + 1, exon_len);
        if (!ref_seq) { exon_res->score = NEG_INF - 1; return false; }
        int64_t o[3];
        loc_right(qseq, seq_remain_cap, ref_seq, (int)exon_len, o);
        int ed = (int)o[0], indel = (int)o[1];
        int64_t score = o[2];
        int64_t new_rmpos = pos + exon_len;
        exon_res->set(new_rmpos, ed, 0, -indel, (int)(exon_len - indel),
                      score);
        if (curr.ed + ed <= ed_th) {
            curr.update(ed, 0, new_rmpos, -indel, (int)(exon_len - indel),
                        score);
            best.update_right(curr, cfg.max_ed, cfg.max_sc);
            return true;
        }
        return false;
    }

    // extend.py _extend_right_end (extend.cpp:462-487)
    bool right_end(int64_t pos, int64_t ref_len, const int8_t* qseq,
                   int qseq_len, int ed_th, AR& best, AR& curr,
                   AR* exon_res) const {
        const int8_t* ref_seq = g.get(pos + 1, ref_len);
        if (!ref_seq) return false;
        int64_t o[4];
        local_right_sc(ref_seq, (int)ref_len, qseq, qseq_len, o);
        int ed = (int)o[0], sclen = (int)o[1], indel = (int)o[2];
        int64_t score = o[3];
        int64_t new_rmpos = pos + qseq_len - indel;
        exon_res->set(new_rmpos, ed, sclen, indel, qseq_len, score);
        int actual_mapped = qseq_len - sclen;
        if (curr.ed + ed <= ed_th && sclen <= cfg.max_sc &&
            actual_mapped >= sclen) {
            curr.update(ed, sclen, new_rmpos, indel, qseq_len, score);
            best.update_by_score_right(curr);
        }
        return true;
    }

    // extend.py _extend_left_middle (extend.cpp:653-679)
    bool left_middle(int64_t pos, int64_t exon_len, const int8_t* qseq_part,
                     int qpart_len, int ed_th, AR& best, AR& curr,
                     AR* exon_res) const {
        const int8_t* ref_seq = g.get(pos - exon_len, exon_len);
        if (!ref_seq) { exon_res->score = NEG_INF - 1; return false; }
        int64_t o[3];
        loc_left(qseq_part, qpart_len, ref_seq, (int)exon_len, o);
        int ed = (int)o[0], indel = (int)o[1];
        int64_t score = o[2];
        int64_t new_lmpos = pos - exon_len;
        exon_res->set(new_lmpos, ed, 0, -indel, (int)(exon_len - indel),
                      score);
        if (curr.ed + ed <= ed_th) {
            curr.update(ed, 0, new_lmpos, -indel, (int)(exon_len - indel),
                        score);
            best.update_left(curr, cfg.max_ed, cfg.max_sc);
            return true;
        }
        return false;
    }

    // extend.py _extend_left_end (extend.cpp:681-705)
    bool left_end(int64_t pos, int64_t ref_len, const int8_t* qseq,
                  int qseq_len, int ed_th, AR& best, AR& curr,
                  AR* exon_res) const {
        const int8_t* ref_seq = g.get(pos - ref_len, ref_len);
        if (!ref_seq) return false;
        int64_t o[4];
        local_left_sc(ref_seq, (int)ref_len, qseq, qseq_len, o);
        int ed = (int)o[0], sclen = (int)o[1], indel = (int)o[2];
        int64_t score = o[3];
        int64_t new_lmpos = pos - qseq_len + indel;
        exon_res->set(new_lmpos, ed, sclen, indel, qseq_len, score);
        int actual_mapped = qseq_len - sclen;
        if (curr.ed + ed <= ed_th && sclen <= cfg.max_sc &&
            actual_mapped >= sclen) {
            curr.update(ed, sclen, new_lmpos, indel, qseq_len, score);
            best.update_by_score_left(curr);
        }
        return true;
    }

    // extend.py _extend_right_trans (extend.cpp:491-650)
    bool right_trans(int tid, int64_t pos, int64_t ref_len,
                     const int8_t* qseq, int qseq_len, int ed_th, int64_t ub,
                     AR& best, Memo& memo) const {
        bool consecutive = false;
        AR curr(ub);
        int32_t iv, it_ind;
        an->overlap_ind(pos, &iv, &it_ind);
        if (iv < 0) return consecutive;
        int it_ind_start = an->trans_start[tid];
        int rel_ind = it_ind - it_ind_start;

        int64_t rspos = pos;
        int64_t exon_len = (int64_t)an->iv_epos[iv] - pos;
        int64_t remain_ref_len = ref_len;
        int covered = 0;
        int t2s_len = an->t2s_len(tid);
        for (int i = rel_ind + 1; i < t2s_len; ++i) {
            if (exon_len >= qseq_len - covered) break;
            int state = an->t2s(tid, i);
            if (state == 1) {
                int indel = 0;
                if (exon_len > 0) {
                    if (rspos + exon_len > ub) return consecutive;
                    int remain_q = (int)std::min(exon_len + cfg.band,
                                                 (int64_t)(qseq_len - covered));
                    MemoKey key{rspos, exon_len, covered, remain_q};
                    auto hit = memo.find(key);
                    if (hit != memo.end()) {
                        const AR& h = hit->second;
                        if (curr.ed + h.ed > ed_th) return consecutive;
                        curr.update(h.ed, h.sclen, h.pos, h.indel, h.qcovlen,
                                    h.score);
                        best.update_right(curr, cfg.max_ed, cfg.max_sc);
                        indel = h.indel;
                    } else {
                        AR exon_res(0);
                        bool success = right_middle(rspos, exon_len,
                                                    qseq + covered, remain_q,
                                                    ed_th, best, curr,
                                                    &exon_res);
                        if (exon_res.score >= NEG_INF)
                            memo.emplace(key, exon_res);
                        if (!success) return consecutive;
                        indel = exon_res.indel;
                    }
                }
                remain_ref_len -= exon_len;
                covered += (int)exon_len + indel;
                exon_len = 0;
                int64_t niv = i + it_ind_start;
                rspos = (int64_t)an->iv_spos[niv] - 1;
            }
            if (state != 0) {
                int64_t niv = i + it_ind_start;
                exon_len += (int64_t)an->iv_epos[niv] -
                            (int64_t)an->iv_spos[niv] + 1;
            }
        }

        // end of transcript with read remaining (extend.cpp:591-619)
        if (0 < exon_len && exon_len < qseq_len - covered &&
            rspos + exon_len <= ub) {
            int remain_q = (int)std::min(exon_len + cfg.band,
                                         (int64_t)(qseq_len - covered));
            MemoKey key{rspos, exon_len, covered, remain_q};
            auto hit = memo.find(key);
            if (hit != memo.end()) {
                const AR& h = hit->second;
                if (curr.ed + h.ed > ed_th) return consecutive;
                curr.update(h.ed, h.sclen, h.pos, h.indel, h.qcovlen, h.score);
                best.update_right(curr, cfg.max_ed, cfg.max_sc);
            } else {
                AR exon_res(0);
                right_middle(rspos, exon_len, qseq + covered, remain_q, ed_th,
                             best, curr, &exon_res);
                if (exon_res.score >= NEG_INF) memo.emplace(key, exon_res);
            }
            return consecutive;
        }

        if (covered >= qseq_len || rspos + qseq_len - covered > ub ||
            exon_len < qseq_len - covered)
            return consecutive;

        consecutive = (rspos == pos);
        remain_ref_len = std::min(remain_ref_len, exon_len);
        MemoKey key{rspos, remain_ref_len, covered, qseq_len - covered};
        auto hit = memo.find(key);
        if (hit != memo.end()) {
            const AR& h = hit->second;
            int actual_mapped = h.qcovlen - h.sclen;
            if (curr.ed + h.ed > ed_th || h.sclen > cfg.max_sc ||
                actual_mapped < h.sclen)
                return consecutive;
            curr.update(h.ed, h.sclen, h.pos, h.indel, h.qcovlen, h.score);
            best.update_by_score_right(curr);
        } else {
            AR exon_res(0);
            if (right_end(rspos, remain_ref_len, qseq + covered,
                          qseq_len - covered, ed_th, best, curr, &exon_res))
                memo.emplace(key, exon_res);
        }
        return consecutive;
    }

    // extend.py _extend_left_trans (extend.cpp:708-875)
    bool left_trans(int tid, int64_t pos, int64_t ref_len, const int8_t* qseq,
                    int qseq_len, int ed_th, int64_t lb, AR& best,
                    Memo& memo) const {
        bool consecutive = false;
        AR curr(lb);
        int32_t iv, it_ind;
        an->overlap_ind(pos, &iv, &it_ind);
        if (iv < 0) return consecutive;
        int it_ind_start = an->trans_start[tid];
        int rel_ind = it_ind - it_ind_start;

        int64_t lepos = pos;
        int64_t exon_len = 0;
        int64_t remain_ref_len = ref_len;
        int covered = 0;
        bool first_seg = true;
        for (int i = rel_ind; i >= 0; --i) {
            int state = an->t2s(tid, i);
            if (state != 0) {
                int64_t niv = i + it_ind_start;
                if (first_seg) {
                    exon_len = pos - (int64_t)an->iv_spos[niv];
                    first_seg = false;
                } else {
                    if (exon_len == 0)
                        lepos = (int64_t)an->iv_epos[niv] + 1;
                    exon_len += (int64_t)an->iv_epos[niv] -
                                (int64_t)an->iv_spos[niv] + 1;
                }
            }
            if (exon_len >= qseq_len - covered) break;
            if (state == 1) {
                int indel = 0;
                if (exon_len > 0) {
                    if (lepos < lb + exon_len) return consecutive;
                    int remain_q = (int)std::min(exon_len + cfg.band,
                                                 (int64_t)(qseq_len - covered));
                    MemoKey key{lepos, exon_len, covered, remain_q};
                    auto hit = memo.find(key);
                    if (hit != memo.end()) {
                        const AR& h = hit->second;
                        if (curr.ed + h.ed > ed_th) return consecutive;
                        curr.update(h.ed, h.sclen, h.pos, h.indel, h.qcovlen,
                                    h.score);
                        best.update_left(curr, cfg.max_ed, cfg.max_sc);
                        indel = h.indel;
                    } else {
                        const int8_t* qpart =
                            qseq + (qseq_len - covered - remain_q);
                        AR exon_res(0);
                        bool success = left_middle(lepos, exon_len, qpart,
                                                   remain_q, ed_th, best,
                                                   curr, &exon_res);
                        if (exon_res.score >= NEG_INF)
                            memo.emplace(key, exon_res);
                        if (!success) return consecutive;
                        indel = exon_res.indel;
                    }
                }
                remain_ref_len -= exon_len;
                covered += (int)exon_len + indel;
                exon_len = 0;
            }
        }

        // reached transcript start with read remaining (extend.cpp:816-845)
        if (0 < exon_len && exon_len < qseq_len - covered &&
            lepos >= lb + exon_len) {
            int remain_q = (int)std::min(exon_len + cfg.band,
                                         (int64_t)(qseq_len - covered));
            MemoKey key{lepos, exon_len, covered, remain_q};
            auto hit = memo.find(key);
            if (hit != memo.end()) {
                const AR& h = hit->second;
                if (curr.ed + h.ed > ed_th) return consecutive;
                curr.update(h.ed, h.sclen, h.pos, h.indel, h.qcovlen, h.score);
                best.update_left(curr, cfg.max_ed, cfg.max_sc);
            } else {
                const int8_t* qpart = qseq + (qseq_len - covered - remain_q);
                AR exon_res(0);
                left_middle(lepos, exon_len, qpart, remain_q, ed_th, best,
                            curr, &exon_res);
                if (exon_res.score >= NEG_INF) memo.emplace(key, exon_res);
            }
            return consecutive;
        }

        if (covered >= qseq_len || lepos < lb + qseq_len - covered ||
            exon_len < qseq_len - covered)
            return consecutive;

        consecutive = (lepos == pos);
        remain_ref_len = std::min(remain_ref_len, exon_len);
        MemoKey key{lepos, remain_ref_len, covered, qseq_len - covered};
        auto hit = memo.find(key);
        if (hit != memo.end()) {
            const AR& h = hit->second;
            int actual_mapped = h.qcovlen - h.sclen;
            if (curr.ed + h.ed > ed_th || h.sclen > cfg.max_sc ||
                actual_mapped < h.sclen)
                return consecutive;
            curr.update(h.ed, h.sclen, h.pos, h.indel, h.qcovlen, h.score);
            best.update_by_score_left(curr);
        } else {
            AR exon_res(0);
            if (left_end(lepos, remain_ref_len, qseq, qseq_len - covered,
                         ed_th, best, curr, &exon_res))
                memo.emplace(key, exon_res);
        }
        return consecutive;
    }

    // extend.py extend_right (extend.cpp:285-360)
    bool extend_right_e(const std::vector<int32_t>& common_tid,
                        const int8_t* qseq, int64_t& pos, int length,
                        int ed_th, int64_t ub, AR& best) const {
        int seq_len = length;
        int64_t ref_len = (int64_t)length + cfg.band;
        int64_t orig_pos = pos;
        bool consecutive = false;
        AR curr(ub);
        best.set(pos, ed_th + 1, length + 1, cfg.band + 1, 0, 0);
        Memo memo;
        for (int32_t tid : common_tid)
            consecutive = right_trans(tid, pos, ref_len, qseq, seq_len, ed_th,
                                      ub, best, memo) || consecutive;

        if (best.ed <= ed_th) {
            pos = best.pos - best.sclen;
            if (best.qcovlen >= seq_len && best.sclen <= cfg.max_sc)
                return true;
        }

        // intron retention: contiguous genomic (extend.cpp:326-341)
        const int8_t* ref_seq = g.get(orig_pos + 1, ref_len);
        if (!consecutive && ref_seq) {
            int64_t o[4];
            local_right_sc(ref_seq, (int)ref_len, qseq, seq_len, o);
            int ed = (int)o[0], sclen = (int)o[1], indel = (int)o[2];
            int64_t score = o[3];
            if (ed <= ed_th && sclen <= cfg.max_sc) {
                curr.set(orig_pos + seq_len - indel, ed, sclen, indel,
                         seq_len, score);
                if (best.update_by_score_right(curr)) {
                    pos = orig_pos + seq_len - indel - sclen;
                    return true;
                }
            }
        }

        if (best.qcovlen <= 0) {
            pos = orig_pos;
            best.set(pos, 0, 0, 0, 0, NEG_INF);
        }
        int qremain = seq_len - best.qcovlen;
        if (qremain + best.sclen <= cfg.max_sc) {
            best.set(pos, best.ed, best.sclen + qremain, best.indel, seq_len,
                     best.score);
            return true;
        }
        return best.qcovlen >= seq_len && best.ed <= ed_th;
    }

    // extend.py extend_left (extend.cpp:361-432)
    bool extend_left_e(const std::vector<int32_t>& common_tid,
                       const int8_t* qseq, int64_t& pos, int length,
                       int ed_th, int64_t lb, AR& best) const {
        int seq_len = length;
        int64_t ref_len = (int64_t)length + cfg.band;
        int64_t orig_pos = pos;
        bool consecutive = false;
        AR curr(lb);
        best.set(pos, ed_th + 1, length + 1, cfg.band + 1, 0, 0);
        Memo memo;
        for (int32_t tid : common_tid)
            consecutive = left_trans(tid, pos, ref_len, qseq, seq_len, ed_th,
                                     lb, best, memo) || consecutive;

        if (best.ed <= ed_th) {
            pos = best.pos + best.sclen;
            if (best.qcovlen >= seq_len && best.sclen <= cfg.max_sc)
                return true;
        }

        const int8_t* ref_seq = g.get(orig_pos - ref_len, ref_len);
        if (!consecutive && ref_seq) {
            int64_t o[4];
            local_left_sc(ref_seq, (int)ref_len, qseq, seq_len, o);
            int ed = (int)o[0], sclen = (int)o[1], indel = (int)o[2];
            int64_t score = o[3];
            if (ed <= ed_th && sclen <= cfg.max_sc) {
                curr.set(orig_pos - seq_len + indel, ed, sclen, indel,
                         seq_len, score);
                if (best.update_by_score_left(curr)) {
                    pos = orig_pos - seq_len + indel + sclen;
                    return true;
                }
            }
        }

        if (best.qcovlen <= 0) {
            pos = orig_pos;
            best.set(pos, 0, 0, 0, 0, NEG_INF);
        }
        int qremain = seq_len - best.qcovlen;
        if (qremain + best.sclen <= cfg.max_sc) {
            best.set(pos, best.ed, best.sclen + qremain, best.indel, seq_len,
                     best.score);
            return true;
        }
        return best.qcovlen >= seq_len && best.ed <= ed_th;
    }

    // extend.py extend_chain_right (extend.cpp:215-246)
    bool extend_chain_right(const std::vector<int32_t>& common_tid,
                            const ChainV& ch, const int8_t* qseq, int seq_len,
                            int64_t ub, MM& mm, int& err) const {
        int last = ch.len - 1;
        int64_t rm_pos = ch.r(last) + ch.f(last) - 1;
        int remain_end = seq_len - (int)(ch.q(last) + ch.f(last));
        bool right_ok = remain_end <= 0;
        AR best(ub);
        if (remain_end > 0)
            right_ok = extend_right_e(common_tid, qseq + seq_len - remain_end,
                                      rm_pos, remain_end,
                                      cfg.max_ed - err, ub, best);
        int sclen_right = best.sclen;
        int err_right = best.ed;
        remain_end -= best.qcovlen;
        mm.epos = rm_pos;
        mm.matched_len -= right_ok ? sclen_right : remain_end;
        mm.qepos -= right_ok ? sclen_right : remain_end;
        mm.sclen_right = sclen_right;
        mm.right_ed = best.ed;
        err += err_right;
        return right_ok;
    }

    // extend.py extend_chain_left (extend.cpp:248-280)
    bool extend_chain_left(const std::vector<int32_t>& common_tid,
                           const ChainV& ch, const int8_t* qseq, int qspos,
                           int64_t lb, MM& mm, int& err) const {
        int64_t lm_pos = ch.r(0);
        int remain_beg = (int)ch.q(0) - qspos;
        bool left_ok = remain_beg <= 0;
        AR best(lb);
        if (remain_beg > 0)
            left_ok = extend_left_e(common_tid, qseq, lm_pos, remain_beg,
                                    cfg.max_ed - err, lb, best);
        int sclen_left = best.sclen;
        int err_left = best.ed;
        remain_beg -= best.qcovlen;
        mm.spos = lm_pos;
        mm.matched_len -= left_ok ? sclen_left : remain_beg;
        mm.qspos += left_ok ? sclen_left : remain_beg;
        mm.sclen_left = sclen_left;
        mm.left_ed = best.ed;
        err += err_left;
        return left_ok;
    }
};  // struct Extender (closed after member fns below are free helpers)

// extend.py estimate_middle_error (utils.cpp:35-49)
int estimate_middle_error(const ChainV& ch, int band) {
    int mid_err = 0;
    for (int i = 0; i + 1 < ch.len; ++i) {
        if (ch.q(i + 1) > ch.q(i) + ch.f(i)) {
            int64_t diff = (ch.r(i + 1) - ch.r(i)) - (ch.q(i + 1) - ch.q(i));
            if (diff == 0) mid_err += 1;
            else if (0 < diff && diff <= band) mid_err += (int)diff;
            else if (-band <= diff && diff < 0) mid_err -= (int)diff;
        }
    }
    return mid_err;
}

// extend.py is_concord (utils.cpp:116-132)
bool is_concord1(const ChainV& ch, int seq_len, MM& mm) {
    if (ch.len < 2) {
        mm.is_concord = false;
    } else if (ch.q(ch.len - 1) + ch.f(ch.len - 1) - ch.q(0) >= seq_len) {
        mm.is_concord = true;
        mm.type = CONCRD;
        mm.spos = ch.r(0);
        mm.epos = ch.r(ch.len - 1) + ch.f(ch.len - 1) - 1;
        mm.matched_len = (int)(ch.q(ch.len - 1) + ch.f(ch.len - 1) - ch.q(0));
        mm.qspos = (int)ch.q(0);
        mm.qepos = (int)(ch.q(ch.len - 1) + ch.f(ch.len - 1) - 1);
    } else {
        mm.is_concord = false;
    }
    return mm.is_concord;
}

// extend.py is_concord2 (utils.cpp:134-153)
bool is_concord2(const ChainV& ch, int seq_len, MM& mm) {
    if (ch.len < 2) {
        mm.is_concord = false;
    } else if (ch.q(ch.len - 1) + ch.f(ch.len - 1) - ch.q(0) >= seq_len) {
        mm.is_concord = true;
        mm.type = CONCRD;
        mm.spos = ch.r(0);
        mm.epos = ch.r(ch.len - 1) + ch.f(ch.len - 1) - 1;
        mm.matched_len = (int)(ch.q(ch.len - 1) + ch.f(ch.len - 1) - ch.q(0));
        mm.qspos = (int)ch.q(0);
        mm.qepos = (int)(ch.q(ch.len - 1) + ch.f(ch.len - 1) - 1);
    } else {
        mm.is_concord = false;
        if (ch.q(0) == 0 || ch.q(ch.len - 1) + ch.f(ch.len - 1) == seq_len)
            mm.type = CANDID;
    }
    return mm.is_concord;
}

// extend.py update_match_mate_info (utils.cpp:22-32)
void update_match_mate_info(bool lok, bool rok, int err, MM& mm,
                            const Cfg& cfg) {
    mm.left_ok = lok && mm.sclen_left <= cfg.max_sc;
    mm.right_ok = rok && mm.sclen_right <= cfg.max_sc;
    if (lok && rok && err <= cfg.max_ed && mm.sclen_right <= cfg.max_sc &&
        mm.sclen_left <= cfg.max_sc) {
        mm.is_concord = true;
        mm.type = CONCRD;
    } else if (lok || rok) {
        mm.type = CANDID;
    } else {
        mm.type = ORPHAN;
    }
}

// extend.py extend_chain_both_sides (extend.cpp:131-213) — genomic path
int extend_chain_both_sides(const Extender& ex, const ChainV& ch,
                            const int8_t* qseq, int seq_len, MM& mm,
                            int direction) {
    const Cfg& cfg = ex.cfg;
    mm.is_concord = false;
    if (ch.len <= 0) {
        mm.type = ORPHAN;
        return mm.type;
    }
    mm.middle_ed = estimate_middle_error(ch, cfg.band);
    if (is_concord1(ch, seq_len, mm)) {
        mm.dir = direction;
        return mm.type;
    }
    std::vector<int32_t> no_tid;

    int64_t lm_pos = ch.r(0);
    int remain_beg = (int)ch.q(0);
    bool left_ok = remain_beg <= 0;
    AR best_left(MINLB);
    if (remain_beg > 0)
        left_ok = ex.extend_left_e(no_tid, qseq, lm_pos, remain_beg,
                                   cfg.max_ed - mm.middle_ed, MINLB,
                                   best_left);
    int err_left = best_left.ed;
    int sclen_left = best_left.sclen;
    remain_beg -= best_left.qcovlen;

    int last = ch.len - 1;
    int64_t rm_pos = ch.r(last) + ch.f(last) - 1;
    int remain_end = seq_len - (int)(ch.q(last) + ch.f(last));
    bool right_ok = remain_end <= 0;
    AR best_right(MAXUB);
    if (remain_end > 0)
        right_ok = ex.extend_right_e(no_tid, qseq + seq_len - remain_end,
                                     rm_pos, remain_end,
                                     cfg.max_ed - mm.middle_ed - err_left,
                                     MAXUB, best_right);
    int err_right = best_right.ed;
    int sclen_right = best_right.sclen;
    remain_end -= best_right.qcovlen;

    mm.spos = lm_pos;
    mm.epos = rm_pos;
    mm.matched_len = seq_len;
    mm.matched_len -= left_ok ? sclen_left : remain_beg;
    mm.matched_len -= right_ok ? sclen_right : remain_end;
    mm.qspos = 1 + (left_ok ? sclen_left : remain_beg);
    mm.qepos = seq_len - (right_ok ? sclen_right : remain_end);
    mm.right_ed = best_right.ed;
    mm.left_ed = best_left.ed;
    mm.dir = direction;
    if (left_ok && right_ok && err_left + err_right <= cfg.max_ed &&
        sclen_left <= cfg.max_sc && sclen_right <= cfg.max_sc) {
        mm.is_concord = true;
        mm.type = CONCRD;
    } else if (left_ok || right_ok) {
        mm.type = CANDID;
    } else {
        mm.type = ORPHAN;
    }
    return mm.type;
}

// extend.py extend_both_mates (extend.cpp:37-125) — paired extension
bool extend_both_mates(const Extender& ex, const ChainV& lch,
                       const ChainV& rch,
                       const std::vector<int32_t>& common_tid,
                       const int8_t* lseq, const int8_t* rseq,
                       int lqspos, int rqspos, int lseq_len, int rseq_len,
                       MM& lmm, MM& rmm) {
    const Cfg& cfg = ex.cfg;
    lmm.middle_ed = ex.calc_middle_ed(lch, cfg.max_ed, lseq, lseq_len);
    rmm.middle_ed = ex.calc_middle_ed(rch, cfg.max_ed, rseq, rseq_len);
    if (lmm.middle_ed <= cfg.max_ed) is_concord2(lch, lseq_len, lmm);
    if (rmm.middle_ed <= cfg.max_ed) is_concord2(rch, rseq_len, rmm);
    if (lmm.middle_ed > cfg.max_ed || rmm.middle_ed > cfg.max_ed)
        return false;

    bool l_extend = true;
    lmm.is_concord = false;
    if (lch.len <= 0) {
        lmm.type = ORPHAN;
        lmm.matched_len = 0;
        l_extend = false;
    }
    bool r_extend = true;
    rmm.is_concord = false;
    if (rch.len <= 0) {
        rmm.type = ORPHAN;
        rmm.matched_len = 0;
        r_extend = false;
    }

    bool llok = false, lrok = false, rlok = false, rrok = false;
    int lerr = lmm.middle_ed;
    int rerr = rmm.middle_ed;
    if (l_extend) {
        lmm.matched_len = lseq_len - lqspos + 1;
        lmm.qspos = lqspos;
        lmm.qepos = lseq_len;
        llok = ex.extend_chain_left(common_tid, lch, lseq, lqspos - 1, MINLB,
                                    lmm, lerr);
    }
    if (r_extend) {
        rmm.matched_len = rseq_len - rqspos + 1;
        rmm.qspos = rqspos;
        rmm.qepos = rseq_len;
        rlok = ex.extend_chain_left(common_tid, rch, rseq, rqspos - 1,
                                    l_extend ? lmm.spos : MINLB, rmm, rerr);
    }
    if (r_extend)
        rrok = ex.extend_chain_right(common_tid, rch, rseq, rseq_len, MAXUB,
                                     rmm, rerr);
    if (l_extend)
        lrok = ex.extend_chain_right(common_tid, lch, lseq, lseq_len,
                                     r_extend ? rmm.epos : MAXUB, lmm, lerr);
    if (l_extend) update_match_mate_info(llok, lrok, lerr, lmm, cfg);
    if (r_extend) update_match_mate_info(rlok, rrok, rerr, rmm, cfg);
    return true;
}

// categories.py calc_tlen (utils.cpp:53-113)
void calc_tlen(const Anno& an, const MM& sm, const MM& lm, int64_t* tlen_out,
               int* intron_out) {
    int64_t min_tlen = INF;
    int best_in = 0;
    for (int64_t e = an.iv_seg_off[sm.exons_epos];
         e < an.iv_seg_off[sm.exons_epos + 1]; ++e) {
        int32_t u = an.seg_uid[e];
        if (u < 0) continue;
        for (int64_t t = an.uid_tid_off[u]; t < an.uid_tid_off[u + 1]; ++t) {
            int tid = an.uid_tid[t];
            int start_ind = an.trans_start[tid];
            int start_ti = sm.exon_ind_epos - start_ind;
            if (start_ti < 0) continue;
            int end_ti = lm.exon_ind_spos - start_ind;
            if (lm.exon_ind_spos < start_ind || end_ti >= an.t2s_len(tid) ||
                an.t2s(tid, end_ti) == 0)
                continue;
            int64_t tlen;
            int inn;
            if (start_ti == end_ti) {
                inn = 0;
                tlen = lm.spos - sm.epos + 1;
            } else {
                bool pre_zero = false;
                inn = 0;
                tlen = (int64_t)an.iv_epos[sm.exons_epos] - sm.epos + 1;
                int this_iv = sm.exon_ind_epos;
                for (int kk = start_ti + 1; kk < end_ti; ++kk) {
                    ++this_iv;
                    if (an.t2s(tid, kk) != 0) {
                        tlen += (int64_t)an.iv_epos[this_iv] -
                                (int64_t)an.iv_spos[this_iv] + 1;
                        pre_zero = false;
                    } else {
                        if (!pre_zero) ++inn;
                        pre_zero = true;
                    }
                }
                tlen += lm.spos - (int64_t)an.iv_spos[lm.exons_spos] + 1;
            }
            if (tlen < min_tlen) {
                best_in = inn;
                min_tlen = tlen;
            }
        }
    }
    if (min_tlen == INF) {
        *tlen_out = -1;
        *intron_out = best_in;
        return;
    }
    *tlen_out = min_tlen + sm.matched_len - 1 + lm.matched_len - 1;
    *intron_out = best_in;
}

// categories.py concordant_explanation (utils.cpp:157-213)
bool concordant_explanation(const Anno& an, const Cfg& cfg, MM& sm, MM& lm,
                            MR& mr, int chr_i, int64_t shift, bool r1_sm,
                            int pair_type) {
    if (sm.spos > lm.spos) return false;
    bool on_cdna = sm.exons_spos >= 0 && sm.exons_epos >= 0 &&
                   lm.exons_spos >= 0 && lm.exons_epos >= 0;

    if (sm.exons_spos < 0 || lm.exons_spos < 0) {
        int64_t tlen = lm.spos - sm.epos - 1 + lm.matched_len +
                       sm.matched_len;
        if (tlen <= cfg.max_tlen || tlen <= MAXDISCRDTLEN)
            mr.update(sm, lm, chr_i, shift, tlen, 0, false, CONGNM, r1_sm,
                      cfg.contig_num);
    } else {
        if (same_exon(an, sm.exons_spos, lm.exons_spos)) {
            int64_t tlen = lm.spos + lm.matched_len - sm.spos;
            if (tlen <= cfg.max_tlen)
                mr.update(sm, lm, chr_i, shift, tlen, 0, on_cdna,
                          pair_type == 0 ? CONCRD : CONGEN, r1_sm,
                          cfg.contig_num);
            else
                mr.update(sm, lm, chr_i, shift, tlen, 0, on_cdna, DISCRD,
                          r1_sm, cfg.contig_num);
        }
    }

    if (sm.exons_epos < 0 || lm.exons_spos < 0) {
        int64_t tlen = lm.spos - sm.epos - 1 + sm.matched_len +
                       lm.matched_len;
        if (tlen <= cfg.max_tlen || tlen <= MAXDISCRDTLEN)
            mr.update(sm, lm, chr_i, shift, tlen, 0, false, CONGNM, r1_sm,
                      cfg.contig_num);
    } else {
        int64_t tlen;
        int intron_num;
        calc_tlen(an, sm, lm, &tlen, &intron_num);
        if (0 <= tlen && tlen <= cfg.max_tlen) {
            mr.update(sm, lm, chr_i, shift, tlen, intron_num, on_cdna,
                      pair_type == 0 ? CONCRD : CONGEN, r1_sm,
                      cfg.contig_num);
        } else {
            if (tlen < 0) {
                tlen = lm.spos - sm.epos - 1 + sm.matched_len +
                       lm.matched_len;
                intron_num = 0;
            }
            mr.update(sm, lm, chr_i, shift, tlen, intron_num, on_cdna, DISCRD,
                      r1_sm, cfg.contig_num);
        }
    }
    return mr.type == CONCRD;
}

// categories.py check_chimeric (utils.cpp:215-231)
bool check_chimeric(const Anno& an, const Cfg& cfg, MM& sm, MM& lm, MR& mr,
                    int chr_i, int64_t shift, bool r1_sm) {
    if (mr.type == CONCRD) return false;
    if (sm.exons_spos < 0 || lm.exons_spos < 0) return false;
    if (same_gene_iv(an, sm.exons_spos, lm.exons_spos) && sm.spos < lm.spos) {
        mr.update(sm, lm, chr_i, shift, lm.epos - sm.spos + 1, 0, false,
                  CHIORF, r1_sm, cfg.contig_num);
        return true;
    }
    return false;
}

// categories.py _lariat_ciRNA (utils.cpp:250-252, 304-306)
bool lariat_ciRNA(const Anno& an, const MM& sm, const MM& lm) {
    if (!(an.intronic(sm.spos) && an.intronic(lm.spos))) return false;
    if (sm.exon_ind_spos < 0 || lm.exon_ind_epos < 0) return false;
    if (sm.exon_ind_spos != lm.exon_ind_epos) return false;
    return (sm.spos - (int64_t)an.iv_epos[sm.exon_ind_spos]) <= LARIAT2BEGTH;
}

// categories.py check_bsj (utils.cpp:235-266)
bool check_bsj(const Anno& an, const Cfg& cfg, MM& sm, MM& lm, MR& mr,
               int chr_i, int64_t shift, bool r1_sm) {
    if (mr.type == CONCRD || mr.type == DISCRD) return false;
    if (!sm.right_ok || !lm.left_ok) return false;
    if (sm.exons_spos < 0 || lm.exons_spos < 0) {
        if ((sm.exons_spos >= 0 && same_gene_mm(an, sm, lm)) ||
            (lm.exons_spos >= 0 && same_gene_mm(an, lm, sm))) {
            mr.update(sm, lm, chr_i, shift, lm.epos - sm.spos + 1, 0, false,
                      CHIBSJ, r1_sm, cfg.contig_num);
            return true;
        }
        if (lariat_ciRNA(an, sm, lm)) {
            mr.update(sm, lm, chr_i, shift, lm.epos - sm.spos + 1, 0, false,
                      CHIBSJ, r1_sm, cfg.contig_num);
            return true;
        }
        return false;
    }
    if (same_gene_iv(an, sm.exons_spos, lm.exons_spos)) {
        mr.update(sm, lm, chr_i, shift, lm.epos - sm.spos + 1, 0, false,
                  CHIBSJ, r1_sm, cfg.contig_num);
        return true;
    }
    return false;
}

// categories.py check_2bsj (utils.cpp:270-320)
bool check_2bsj(const Anno& an, const Cfg& cfg, MM& sm, MM& lm, MR& mr,
                int chr_i, int64_t shift, bool r1_sm) {
    if (mr.type < CHI2BSJ) return false;
    if (sm.spos > lm.spos) return false;
    if (sm.right_ok && lm.right_ok && sm.spos != lm.spos) return false;
    if (sm.left_ok && lm.left_ok && sm.epos != lm.epos) return false;
    if (sm.left_ok && lm.right_ok) return false;
    if (sm.exons_spos < 0 || lm.exons_spos < 0) {
        if ((sm.exons_spos >= 0 && same_gene_mm(an, sm, lm)) ||
            (lm.exons_spos >= 0 && same_gene_mm(an, lm, sm))) {
            mr.update(sm, lm, chr_i, shift, lm.epos - sm.spos + 1, 0, false,
                      CHI2BSJ, r1_sm, cfg.contig_num);
            return true;
        }
        if (lariat_ciRNA(an, sm, lm)) {
            mr.update(sm, lm, chr_i, shift, lm.epos - sm.spos + 1, 0, false,
                      CHI2BSJ, r1_sm, cfg.contig_num);
            return true;
        }
        return false;
    }
    if (same_gene_iv(an, sm.exons_spos, lm.exons_spos)) {
        mr.update(sm, lm, chr_i, shift, lm.epos - sm.spos + 1, 0, false,
                  CHI2BSJ, r1_sm, cfg.contig_num);
        return true;
    }
    return false;
}

// io/fasta.py get_shift (gene_annotation.cpp:451-457)
struct ShiftTab {
    const int64_t* shift;  // [n] chromosome start offsets within the contig
    int n;
    // returns index into the table (the chr id) — shift value via shift[]
    int find(int64_t loc) const {
        int i = 1;
        while (i < n && loc >= shift[i]) ++i;
        return i - 1;
    }
};

struct MatePair {
    int type;       // 0 same-tr, 1 same-gene, 2 distance
    double score;
    int fwd_idx, rev_idx;
    std::vector<int32_t> common_tid;
};

// one read pair's working state for process_read_pe
struct PairCtx {
    const Extender* ex;
    const Anno* an;
    const Cfg* cfg;
    ShiftTab shifts;
    // chain sets per orientation o (0 r1fwd, 1 r1rc, 2 r2fwd, 3 r2rc)
    std::vector<ChainV> ch[4];
    int high[4];
    const int8_t* seq[4];
    int seq_len2[2];  // per mate
    MR* mr;
};

// mapping.py pair_chains (filter.cpp:485-551)
void pair_chains(PairCtx& P, const std::vector<ChainV>& fwd,
                 const std::vector<ChainV>& rev, int saved_type,
                 std::vector<MatePair>& pairs, std::vector<char>& f_paired,
                 std::vector<char>& r_paired) {
    const Anno& an = *P.an;
    const Cfg& cfg = *P.cfg;
    pairs.clear();
    f_paired.assign(fwd.size(), 0);
    r_paired.assign(rev.size(), 0);
    std::vector<int32_t> f_iv(fwd.size()), f_raw(fwd.size());
    std::vector<int32_t> r_iv(rev.size()), r_raw(rev.size());
    for (size_t i = 0; i < fwd.size(); ++i)
        an.overlap_ind(fwd[i].rbeg(), &f_iv[i], &f_raw[i]);
    for (size_t j = 0; j < rev.size(); ++j)
        an.overlap_ind(rev[j].rbeg(), &r_iv[j], &r_raw[j]);
    std::vector<int32_t> common_tid;
    for (size_t i = 0; i < fwd.size(); ++i) {
        for (size_t j = 0; j < rev.size(); ++j) {
            int64_t fs = fwd[i].rbeg();
            int64_t rs = rev[j].rbeg();
            int64_t fe = fwd[i].rend();
            int64_t re = rev[j].rend();
            int64_t tlen = (fs < rs) ? (re - fs) : (fe - rs);
            common_tid.clear();
            bool same_tr = false, same_gen = false;
            if (f_iv[i] >= 0 && r_iv[j] >= 0) {
                same_transcript2(an, f_iv[i], r_iv[j], common_tid);
                same_tr = !common_tid.empty();
            }
            if (!same_tr && f_iv[i] >= 0 &&
                ((cfg.scan_level == 0 && saved_type > CONGEN) ||
                 (cfg.scan_level > 0 && saved_type >= CONGEN)))
                same_gen = same_gene_span(an, f_iv[i], rs, re);
            if (!same_gen && r_iv[j] >= 0 && saved_type >= CONGEN)
                same_gen = same_gene_span(an, r_iv[j], fs, fe);
            if (same_tr || same_gen ||
                (tlen <= MAXDISCRDTLEN && saved_type >= CONGNM)) {
                MatePair mp;
                mp.type = same_tr ? 0 : (same_gen ? 1 : 2);
                mp.score = fwd[i].score + rev[j].score;
                mp.fwd_idx = (int)i;
                mp.rev_idx = (int)j;
                mp.common_tid = common_tid;
                pairs.push_back(std::move(mp));
                f_paired[i] = 1;
                r_paired[j] = 1;
            }
        }
    }
}

// mapping.py process_mates (filter.cpp:244-395)
int process_mates(PairCtx& P, int fo, int bo, bool r1_forward) {
    // fo/bo: orientation indices of the forward/backward chain sets
    const Anno& an = *P.an;
    const Cfg& cfg = *P.cfg;
    const Extender& ex = *P.ex;
    MR& mr = *P.mr;
    const std::vector<ChainV>& fwd = P.ch[fo];
    const std::vector<ChainV>& bwd = P.ch[bo];
    int fwd_len = P.seq_len2[fo >> 1];
    int bwd_len = P.seq_len2[bo >> 1];
    const int8_t* fwd_seq = P.seq[fo];
    const int8_t* bwd_seq = P.seq[bo];

    std::vector<MatePair> pairs;
    std::vector<char> f_paired, r_paired;
    pair_chains(P, fwd, bwd, mr.type, pairs, f_paired, r_paired);

    int min_ret1 = ORPHAN, min_ret2 = ORPHAN;
    bool r1_genic = false, r2_genic = false;

    for (MatePair& mp : pairs) {
        MM r1_mm = MM::dflt(cfg.max_ed);
        MM r2_mm = MM::dflt(cfg.max_ed);
        r1_mm.dir = 1;
        r2_mm.dir = -1;
        const ChainV& fc = fwd[mp.fwd_idx];
        const ChainV& rc = bwd[mp.rev_idx];
        bool is_fwd_left = is_left_chain(fc, rc, fwd_len);
        if (is_fwd_left) {
            bool success = extend_both_mates(
                ex, fc, rc, mp.common_tid, fwd_seq, bwd_seq, 1, 1, fwd_len,
                bwd_len, r1_mm, r2_mm);
            if (success) {
                int chr_i = P.shifts.find(r1_mm.spos);
                int64_t shift = P.shifts.shift[chr_i];
                overlap_to_epos(r1_mm, an);
                overlap_to_spos(r1_mm, an);
                overlap_to_epos(r2_mm, an);
                overlap_to_spos(r2_mm, an);
                if (r1_mm.type == CONCRD && r2_mm.type == CONCRD) {
                    if (concordant_explanation(an, cfg, r1_mm, r2_mm, mr,
                                               chr_i, shift, r1_forward,
                                               mp.type) &&
                        cfg.scan_level == 0)
                        return CONCRD;
                } else if ((r1_mm.type == CANDID && r2_mm.type == CONCRD) ||
                           (r1_mm.type == CONCRD && r2_mm.type == CANDID)) {
                    check_bsj(an, cfg, r1_mm, r2_mm, mr, chr_i, shift,
                              r1_forward);
                } else if (r1_mm.type == CANDID && r2_mm.type == CANDID) {
                    check_2bsj(an, cfg, r1_mm, r2_mm, mr, chr_i, shift,
                               r1_forward);
                }
            }
        } else {
            bool success = extend_both_mates(
                ex, rc, fc, mp.common_tid, bwd_seq, fwd_seq, 1, 1, bwd_len,
                fwd_len, r2_mm, r1_mm);
            if (success) {
                int chr_i = P.shifts.find(r2_mm.spos);
                int64_t shift = P.shifts.shift[chr_i];
                overlap_to_epos(r1_mm, an);
                overlap_to_spos(r1_mm, an);
                overlap_to_epos(r2_mm, an);
                overlap_to_spos(r2_mm, an);
                if (r1_mm.type == CONCRD && r2_mm.type == CONCRD) {
                    check_chimeric(an, cfg, r2_mm, r1_mm, mr, chr_i, shift,
                                   !r1_forward);
                } else if ((r1_mm.type == CANDID && r2_mm.type == CONCRD) ||
                           (r1_mm.type == CONCRD && r2_mm.type == CANDID)) {
                    check_bsj(an, cfg, r2_mm, r1_mm, mr, chr_i, shift,
                              !r1_forward);
                } else if (r1_mm.type == CANDID && r2_mm.type == CANDID) {
                    check_2bsj(an, cfg, r2_mm, r1_mm, mr, chr_i, shift,
                               !r1_forward);
                }
            }
        }
        min_ret1 = std::min(r1_mm.type, min_ret1);
        min_ret2 = std::min(r2_mm.type, min_ret2);
        r1_genic = r1_mm.exons_spos >= 0 || r1_mm.exons_epos >= 0;
        r2_genic = r2_mm.exons_spos >= 0 || r2_mm.exons_epos >= 0;
    }

    if (mr.type == CONCRD || mr.type == DISCRD || mr.type == CHIORF ||
        mr.type == CHIBSJ || mr.type == CHI2BSJ)
        return mr.type;

    // leftover single-chain extension (filter.cpp:356-394)
    if (min_ret1 != CONCRD) {
        for (size_t i = 0; i < fwd.size(); ++i) {
            if (!f_paired[i]) {
                MM mm1 = MM::dflt(cfg.max_ed);
                int ex_ret = extend_chain_both_sides(ex, fwd[i], fwd_seq,
                                                     fwd_len, mm1, 1);
                min_ret1 = std::min(ex_ret, min_ret1);
                overlap_to_spos(mm1, an);
                overlap_to_epos(mm1, an);
                r1_genic = mm1.exons_spos >= 0 || mm1.exons_epos >= 0;
            }
        }
    }
    if (min_ret2 != CONCRD) {
        for (size_t i = 0; i < bwd.size(); ++i) {
            if (!r_paired[i]) {
                MM mm2 = MM::dflt(cfg.max_ed);
                int ex_ret = extend_chain_both_sides(ex, bwd[i], bwd_seq,
                                                     bwd_len, mm2, -1);
                min_ret2 = std::min(ex_ret, min_ret2);
                overlap_to_spos(mm2, an);
                overlap_to_epos(mm2, an);
                r2_genic = mm2.exons_spos >= 0 || mm2.exons_epos >= 0;
            }
        }
    }

    int new_type;
    if ((min_ret1 == ORPHAN && min_ret2 == CONCRD) ||
        (min_ret1 == CONCRD && min_ret2 == ORPHAN))
        new_type = OEANCH;
    else if (min_ret1 == ORPHAN || min_ret2 == ORPHAN)
        new_type = ORPHAN;
    else if (min_ret1 == CONCRD && min_ret2 == CONCRD && r1_genic && r2_genic)
        new_type = CHIFUS;
    else if (min_ret1 == CONCRD && min_ret2 == CONCRD)
        new_type = OEA2;
    else
        new_type = CANDID;
    P.mr->update_type(new_type);
    return P.mr->type;
}

// mapping.py process_read_pe (filter.cpp:124-241)
int process_read_pe(PairCtx& P) {
    const Cfg& cfg = *P.cfg;
    MR& mr = *P.mr;
    size_t n_fc1 = P.ch[0].size(), n_bc1 = P.ch[1].size();
    size_t n_fc2 = P.ch[2].size(), n_bc2 = P.ch[3].size();
    if (n_fc1 + n_bc1 + n_fc2 + n_bc2 == 0) {
        if (P.high[0] + P.high[1] > 0 && P.high[2] + P.high[3] > 0) {
            mr.update_type(NOPROC_MANYHIT);
            return NOPROC_MANYHIT;
        }
        mr.update_type(NOPROC_NOMATCH);
        return NOPROC_NOMATCH;
    }
    if (n_fc1 + n_bc1 == 0 || n_fc2 + n_bc2 == 0) {
        mr.update_type(OEANCH);
        return OEANCH;
    }
    double fc1 = n_fc1 ? P.ch[0][0].score : 0.0;
    double bc1 = n_bc1 ? P.ch[1][0].score : 0.0;
    double fc2 = n_fc2 ? P.ch[2][0].score : 0.0;
    double bc2 = n_bc2 ? P.ch[3][0].score : 0.0;

    if (fc1 + bc2 >= fc2 + bc1) {
        int att1 = process_mates(P, 0, 3, true);
        if (cfg.scan_level == 0 && att1 == CONCRD) return CONCRD;
        int att2 = process_mates(P, 2, 1, false);
        if (cfg.scan_level == 0 && att2 == CONCRD) return CONCRD;
    } else {
        int att1 = process_mates(P, 2, 1, false);
        if (cfg.scan_level == 0 && att1 == CONCRD) return CONCRD;
        int att2 = process_mates(P, 0, 3, true);
        if (cfg.scan_level == 0 && att2 == CONCRD) return CONCRD;
    }
    return mr.type;
}

}  // namespace

extern "C" {

// MatchedRead state layout per pair, int64[20] (ops/filter_native.py):
// 0 type | 1 spos_r1 2 epos_r1 3 qspos_r1 4 qepos_r1 5 mlen_r1 6 ed_r1
// 7 fwd_r1 | 8..14 same for r2 | 15 tlen 16 junc_num 17 gm_compatible
// 18 chr_idx 19 contig_num
constexpr int MRN = 20;

void batch_filter_pe(
    // reads: orientation-major [4*n_pairs, L] (r1f, r1rc, r2f, r2rc)
    const int8_t* seqs, const int32_t* lens, int32_t n_pairs, int32_t L,
    // chains from batch_chain: [4n, C, NL] / [4n, C] / [4n]
    const int32_t* ch_rpos, const int32_t* ch_qpos, const int32_t* ch_clen,
    const double* ch_score, const int32_t* ch_n, const int32_t* high,
    int32_t C, int32_t NL,
    // genome (packed contig, 1-based addressing)
    const int8_t* genome, int64_t glen,
    // flat annotation (annotation/annotation.py::ContigAnnotation)
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
    // chromosome shift table of this contig
    const int64_t* shift_vals, int32_t n_shift,
    // config + score matrix
    int32_t kmer, int32_t max_ed, int32_t max_sc, int32_t band,
    int32_t max_tlen, int32_t scan_level, int32_t contig_num,
    int32_t mat, int32_t mis, int32_t ind, int32_t xd, int32_t align_type,
    // in/out per-pair MatchedRead state [n_pairs, MRN]
    int64_t* mr_state,
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

    Cfg cfg;
    cfg.kmer = kmer; cfg.max_ed = max_ed; cfg.max_sc = max_sc;
    cfg.band = band; cfg.max_tlen = max_tlen; cfg.scan_level = scan_level;
    cfg.contig_num = contig_num;
    cfg.mat = mat; cfg.mis = mis; cfg.ind = ind; cfg.xd = xd;
    cfg.align_type = align_type;

    Extender ex;
    ex.an = &an;
    ex.g = Genome{genome, glen};
    ex.cfg = cfg;

    auto worker = [&](int t0, int stride) {
        for (int p = t0; p < n_pairs; p += stride) {
            int64_t* st = mr_state + (int64_t)p * MRN;
            // scan_level 0: already concordant from an earlier contig pass
            if (scan_level == 0 && st[0] == CONCRD) continue;
            MR mr;
            mr.type = (int)st[0];
            mr.spos_r1 = st[1]; mr.epos_r1 = st[2];
            mr.qspos_r1 = (int)st[3]; mr.qepos_r1 = (int)st[4];
            mr.mlen_r1 = (int)st[5]; mr.ed_r1 = (int)st[6];
            mr.r1_forward = st[7] != 0;
            mr.spos_r2 = st[8]; mr.epos_r2 = st[9];
            mr.qspos_r2 = (int)st[10]; mr.qepos_r2 = (int)st[11];
            mr.mlen_r2 = (int)st[12]; mr.ed_r2 = (int)st[13];
            mr.r2_forward = st[14] != 0;
            mr.tlen = st[15]; mr.junc_num = (int)st[16];
            mr.gm_compatible = st[17] != 0;
            mr.chr_idx = (int)st[18]; mr.contig_num = (int)st[19];

            PairCtx P;
            P.ex = &ex; P.an = &an; P.cfg = &cfg;
            P.shifts = ShiftTab{shift_vals, n_shift};
            P.mr = &mr;
            for (int o = 0; o < 4; ++o) {
                int r = 4 * p + o;
                P.seq[o] = seqs + (int64_t)r * L;
                P.high[o] = high[r];
                int cn = ch_n[r];
                P.ch[o].clear();
                P.ch[o].reserve(cn);
                for (int c = 0; c < cn; ++c) {
                    ChainV cv;
                    cv.rpos = ch_rpos + ((int64_t)r * C + c) * NL;
                    cv.qpos = ch_qpos + ((int64_t)r * C + c) * NL;
                    cv.len = ch_clen[(int64_t)r * C + c];
                    cv.score = ch_score[(int64_t)r * C + c];
                    cv.k = kmer;
                    P.ch[o].push_back(cv);
                }
            }
            P.seq_len2[0] = lens[4 * p];
            P.seq_len2[1] = lens[4 * p + 2];

            process_read_pe(P);

            st[0] = mr.type;
            st[1] = mr.spos_r1; st[2] = mr.epos_r1;
            st[3] = mr.qspos_r1; st[4] = mr.qepos_r1;
            st[5] = mr.mlen_r1; st[6] = mr.ed_r1;
            st[7] = mr.r1_forward ? 1 : 0;
            st[8] = mr.spos_r2; st[9] = mr.epos_r2;
            st[10] = mr.qspos_r2; st[11] = mr.qepos_r2;
            st[12] = mr.mlen_r2; st[13] = mr.ed_r2;
            st[14] = mr.r2_forward ? 1 : 0;
            st[15] = mr.tlen; st[16] = mr.junc_num;
            st[17] = mr.gm_compatible ? 1 : 0;
            st[18] = mr.chr_idx; st[19] = mr.contig_num;
        }
    };
    int T = n_threads > 0 ? n_threads : 1;
    if (T == 1) {
        worker(0, 1);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t) ts.emplace_back(worker, t, T);
        for (auto& th : ts) th.join();
    }
}

// SE pipeline (mapping.py process_read_se; filter.cpp:86-121).  Chains for
// orientations 0 (fwd) and 1 (rc) of each read; per-read category out, and
// the successful mate recorded into mr_state when CONCRD.
void batch_filter_se(
    const int8_t* seqs, const int32_t* lens, int32_t n_reads, int32_t L,
    const int32_t* ch_rpos, const int32_t* ch_qpos, const int32_t* ch_clen,
    const double* ch_score, const int32_t* ch_n,
    int32_t C, int32_t NL,
    const int8_t* genome, int64_t glen,
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
    int32_t kmer, int32_t max_ed, int32_t max_sc, int32_t band,
    int32_t max_tlen, int32_t scan_level, int32_t contig_num,
    int32_t mat, int32_t mis, int32_t ind, int32_t xd, int32_t align_type,
    int64_t* mr_state, int32_t* state_out, int32_t n_threads) {

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

    Cfg cfg;
    cfg.kmer = kmer; cfg.max_ed = max_ed; cfg.max_sc = max_sc;
    cfg.band = band; cfg.max_tlen = max_tlen; cfg.scan_level = scan_level;
    cfg.contig_num = contig_num;
    cfg.mat = mat; cfg.mis = mis; cfg.ind = ind; cfg.xd = xd;
    cfg.align_type = align_type;

    Extender ex;
    ex.an = &an;
    ex.g = Genome{genome, glen};
    ex.cfg = cfg;

    ShiftTab shifts{shift_vals, n_shift};

    auto worker = [&](int t0, int stride) {
        for (int p = t0; p < n_reads; p += stride) {
            int64_t* st = mr_state + (int64_t)p * MRN;
            if (scan_level == 0 && st[0] == CONCRD) continue;
            int seq_len = lens[2 * p];
            int min_ret = ORPHAN;
            bool done = false;
            for (int o = 0; o < 2 && !done; ++o) {
                int r = 2 * p + o;
                const int8_t* q = seqs + (int64_t)r * L;
                int cn = ch_n[r];
                for (int c = 0; c < cn; ++c) {
                    ChainV cv;
                    cv.rpos = ch_rpos + ((int64_t)r * C + c) * NL;
                    cv.qpos = ch_qpos + ((int64_t)r * C + c) * NL;
                    cv.len = ch_clen[(int64_t)r * C + c];
                    cv.score = ch_score[(int64_t)r * C + c];
                    cv.k = kmer;
                    MM mm = MM::dflt(cfg.max_ed);
                    int ex_ret = extend_chain_both_sides(ex, cv, q, seq_len,
                                                         mm, o == 0 ? 1 : -1);
                    if (ex_ret == CONCRD) {
                        int chr_i = shifts.find(mm.spos);
                        int64_t shift = shifts.shift[chr_i];
                        st[0] = CONCRD;
                        st[1] = mm.spos - shift;
                        st[2] = mm.epos - shift;
                        st[3] = mm.qspos; st[4] = mm.qepos;
                        st[5] = mm.matched_len;
                        st[6] = mm.ed();
                        st[7] = o == 0 ? 1 : 0;
                        st[18] = chr_i;
                        st[19] = contig_num;
                        min_ret = CONCRD;
                        done = true;
                        break;
                    }
                    min_ret = std::min(ex_ret, min_ret);
                }
            }
            state_out[p] = min_ret;
        }
    };
    int T = n_threads > 0 ? n_threads : 1;
    if (T == 1) {
        worker(0, 1);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t) ts.emplace_back(worker, t, T);
        for (auto& th : ts) th.join();
    }
}

}  // extern "C"

// circRNA-calling stage (same .so; reuses everything above)
#include "circ_kernels.cpp"
