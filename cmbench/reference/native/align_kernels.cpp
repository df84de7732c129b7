// Native host-side alignment kernels for circminer-tpu.
//
// Semantics mirror ops/align.py (the Python oracle, itself modeled on the
// reference CircMiner's banded DP family, src/align.cpp): banded global edit
// distance (forward/reverse), one-sided banded edit distance, X-drop
// anti-diagonal score DP, and the soft-clip-aware wrapper scans.
//
// Sequences are int8 base codes (A0 C1 G2 T3 N4); any code >= 4 mismatches
// everything.  All functions are plain C ABI for ctypes.
//
// Build: cc -O3 -shared -fPIC align_kernels.cpp -o libalign.so

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr int64_t DPTINF = 10000000;
constexpr int MAXN = 1024;

inline int diff(int8_t a, int8_t b) {
    return (a != b || a >= 4 || b >= 4) ? 1 : 0;
}

// full edit-distance DP; dp is (n+1) x (m+1) row-major with stride (m+1)
void full_dp(const int8_t* s, int n, const int8_t* t, int m, int64_t* dp) {
    const int W = m + 1;
    for (int i = 0; i <= n; ++i) dp[i * W] = i;
    for (int j = 0; j <= m; ++j) dp[j] = j;
    for (int i = 1; i <= n; ++i) {
        const int8_t si = s[i - 1];
        int64_t* row = dp + i * W;
        const int64_t* prev = dp + (i - 1) * W;
        for (int j = 1; j <= m; ++j) {
            int64_t v = prev[j - 1] + diff(si, t[j - 1]);
            int64_t v2 = prev[j] + 1;
            if (v2 < v) v = v2;
            int64_t v3 = row[j - 1] + 1;
            if (v3 < v) v = v3;
            row[j] = v;
        }
    }
}

// banded edit-distance DP with band w; DPTINF outside band; falls back to
// the full DP for tiny inputs exactly like the oracle.
void banded_dp(const int8_t* s, int n, const int8_t* t, int m, int w,
               int64_t* dp) {
    const int W = m + 1;
    if (w < 0 || n <= 2 * w || m <= w) {
        full_dp(s, n, t, m, dp);
        return;
    }
    for (int i = 0; i <= n; ++i)
        for (int j = 0; j <= m; ++j) dp[i * W + j] = DPTINF;
    for (int i = 0; i <= w; ++i) dp[i * W] = i;
    for (int j = 0; j <= w; ++j) dp[j] = j;
    for (int j = 1; j <= m; ++j) {
        int lo = std::max(1, j - w);
        int hi = std::min(j + w, n);
        for (int i = lo; i <= hi; ++i) {
            int64_t v = dp[(i - 1) * W + (j - 1)] + diff(s[i - 1], t[j - 1]);
            int64_t v2 = dp[(i - 1) * W + j] + 1;
            if (v2 < v) v = v2;
            int64_t v3 = dp[i * W + (j - 1)] + 1;
            if (v3 < v) v = v3;
            dp[i * W + j] = v;
        }
    }
}

struct Candid {
    int64_t ed, sclen, indel, score;
    bool has;
};

inline bool better(const Candid& a, const Candid& b) {
    // AlignCandid::operator< — higher score, then lower ed, then |indel|
    if (a.score != b.score) return a.score > b.score;
    if (a.ed != b.ed) return a.ed < b.ed;
    int64_t ai = a.indel < 0 ? -a.indel : a.indel;
    int64_t bi = b.indel < 0 ? -b.indel : b.indel;
    return ai < bi;
}

thread_local int64_t g_dp[(MAXN + 1) * (MAXN + 1)];

}  // namespace

extern "C" {

// --- soft-clip-aware prefix scans (EditDist wrappers) -----------------------
// Returns via out[4]: ed, sclen, indel, align_score.
void edit_local_right_sc(const int8_t* s, int n, const int8_t* t, int m,
                         int w, int max_ed, int max_sc, int64_t* out) {
    const int W = m + 1;
    banded_dp(s, n, t, m, w, g_dp);
    int max_sclen = std::min(max_sc, m);
    Candid best{max_ed + 1, max_sc + 1, w + 1, 0, false};
    best.score = -best.sclen - 2 * best.ed;
    for (int j = m; j >= m - max_sclen; --j) {
        for (int i = std::max(0, j - w); i <= std::min(j + w, n); ++i) {
            int64_t d = g_dp[i * W + j];
            if (d <= max_ed) {
                Candid c{d, m - j, j - i, -(m - j) - 2 * d, true};
                if (better(c, best)) best = c;
            }
        }
    }
    if (m <= max_ed) {
        Candid c{m, 0, 0, -2 * (int64_t)m, true};
        if (better(c, best)) best = c;
    }
    out[0] = best.ed;
    out[1] = best.sclen;
    out[2] = best.indel;
    out[3] = m - best.sclen - 2 * best.ed;
}

void edit_local_left_sc(const int8_t* s, int n, const int8_t* t, int m,
                        int w, int max_ed, int max_sc, int64_t* out) {
    // reverse both strings, then identical to right
    int8_t rs[MAXN], rt[MAXN];
    for (int i = 0; i < n; ++i) rs[i] = s[n - 1 - i];
    for (int j = 0; j < m; ++j) rt[j] = t[m - 1 - j];
    edit_local_right_sc(rs, n, rt, m, w, max_ed, max_sc, out);
}

// --- no-clip variants (middle-exon alignment) --------------------------------
// out[3]: ed, indel, align_score(-ed)
void local_right(const int8_t* s, int n, const int8_t* t, int m,
                 int w, int max_ed, int max_sc, int64_t* out) {
    const int W = m + 1;
    banded_dp(s, n, t, m, w, g_dp);
    Candid best{max_ed + 1, max_sc + 1, w + 1, 0, false};
    best.score = -best.sclen - 2 * best.ed;
    for (int i = std::max(0, m - w); i <= std::min(m + w, n); ++i) {
        int64_t d = g_dp[i * W + m];
        if (d <= max_ed) {
            Candid c{d, 0, m - i, -2 * d, true};
            if (better(c, best)) best = c;
        }
    }
    out[0] = best.ed;
    out[1] = best.indel;
    out[2] = -best.ed;
}

void local_left(const int8_t* s, int n, const int8_t* t, int m,
                int w, int max_ed, int max_sc, int64_t* out) {
    int8_t rs[MAXN], rt[MAXN];
    for (int i = 0; i < n; ++i) rs[i] = s[n - 1 - i];
    for (int j = 0; j < m; ++j) rt[j] = t[m - 1 - j];
    local_right(rs, n, rt, m, w, max_ed, max_sc, out);
}

// --- one-sided banded edit distance ------------------------------------------
int64_t one_side_banded(const int8_t* s, int n, const int8_t* t, int m,
                        int w) {
    const int W = m + 1;
    if (w < 0 || n <= w) {
        full_dp(s, n, t, m, g_dp);
        return g_dp[n * W + m];
    }
    for (int i = 0; i <= n; ++i)
        for (int j = 0; j <= m; ++j) g_dp[i * W + j] = DPTINF;
    for (int j = 0; j <= std::min(w, m); ++j) g_dp[j] = j;
    for (int i = 1; i <= n; ++i) {
        for (int j = i; j <= std::min(i + w, m); ++j) {
            int64_t v = g_dp[(i - 1) * W + (j - 1)] +
                        diff(s[i - 1], t[j - 1]);
            int64_t v2 = g_dp[(i - 1) * W + j] + 1;
            if (v2 < v) v = v2;
            if (j >= 1) {
                int64_t v3 = g_dp[i * W + (j - 1)] + 1;
                if (v3 < v) v = v3;
            }
            g_dp[i * W + j] = v;
        }
    }
    return g_dp[n * W + m];
}

// --- X-drop anti-diagonal score DP -------------------------------------------
// out[3]: best_score, on_s, on_t
void xdrop_align(const int8_t* s, int n, const int8_t* t, int m,
                 int w, int mat, int mis, int ind, int xd, int64_t* out) {
    const int W = m + 1;
    int64_t* dpx = g_dp;
    for (int i = 0; i <= n; ++i)
        for (int j = 0; j <= m; ++j) dpx[i * W + j] = -DPTINF;
    for (int i = 0; i <= std::min(w, n); ++i) dpx[i * W] = (int64_t)i * ind;
    for (int j = 0; j <= std::min(w, m); ++j) dpx[j] = (int64_t)j * ind;
    out[0] = 0; out[1] = 0; out[2] = 0;
    if (m <= 0 || n <= 0) return;

    int64_t pre_opt = 0, cur_opt = 0;
    int lb = 1, ub = 1, pre_ub = 0;
    int best_i = 0, best_j = 0;
    for (int k = 2; k <= m + n; ++k) {
        int new_ub = -1;
        for (int i = lb; i <= ub; ++i) {
            int j = k - i;
            if (j < 1 || j > m || i > n) continue;
            int sub = (s[i - 1] == t[j - 1] && s[i - 1] < 4) ? mat : mis;
            int64_t v = dpx[(i - 1) * W + (j - 1)] + sub;
            int64_t v2 = dpx[(i - 1) * W + j] + ind;
            if (v2 > v) v = v2;
            int64_t v3 = dpx[i * W + (j - 1)] + ind;
            if (v3 > v) v = v3;
            dpx[i * W + j] = v;
            if (v >= cur_opt) {
                cur_opt = v;
                best_i = i;
                best_j = j;
            }
            if (v + xd < pre_opt) dpx[i * W + j] = -DPTINF;
            if (dpx[i * W + j] > -DPTINF) new_ub = i;
        }
        int lb_t = k - lb;
        if (lb_t == m || (k > w && (k - w) % 2 == 0)) ++lb;
        if (ub < n && (k <= w || (k > w && (k - w) % 2 == 1))) ++ub;
        if ((pre_ub == -1 && new_ub == -1) || lb > ub) break;
        pre_ub = new_ub;
        if (cur_opt > pre_opt) pre_opt = cur_opt;
    }
    out[0] = dpx[best_i * W + best_j];
    out[1] = best_i;
    out[2] = best_j;
}

// drop wrapper: out[4] = ed, sclen, indel, align_score
void drop_local_right_sc(const int8_t* s, int n, const int8_t* t, int m,
                         int w, int max_ed, int max_sc,
                         int mat, int mis, int ind, int xd, int64_t* out) {
    int64_t r[3];
    xdrop_align(s, n, t, m, w, mat, mis, ind, xd, r);
    int64_t score = r[0];
    int64_t on_s = r[1], on_t = r[2];
    int64_t mx = on_s > on_t ? on_s : on_t;
    int64_t ed = (mat * mx - score) / (mat - mis);
    int64_t indel = on_t - on_s;
    int64_t clip = m - on_t;
    // AlignCandid best(max_ed+1, max(max_sc,m)+1, w+1, 0) then update
    Candid best{max_ed + 1, std::max((int64_t)max_sc, (int64_t)m) + 1,
                w + 1, 0, false};
    if (ed <= max_ed) {
        Candid c{ed, clip, indel, score, true};
        if (better(c, best)) best = c;
    }
    out[0] = best.ed;
    out[1] = best.sclen;
    out[2] = best.indel;
    out[3] = score;
}

void drop_local_left_sc(const int8_t* s, int n, const int8_t* t, int m,
                        int w, int max_ed, int max_sc,
                        int mat, int mis, int ind, int xd, int64_t* out) {
    int8_t rs[MAXN], rt[MAXN];
    for (int i = 0; i < n; ++i) rs[i] = s[n - 1 - i];
    for (int j = 0; j < m; ++j) rt[j] = t[m - 1 - j];
    int64_t r[3];
    xdrop_align(rs, n, rt, m, w, mat, mis, ind, xd, r);
    int64_t score = r[0];
    int64_t on_s = r[1], on_t = r[2];
    int64_t mx = on_s > on_t ? on_s : on_t;
    int64_t ed = (mat * mx - score) / (mat - mis);
    int64_t indel = on_t - on_s;
    int64_t clip = m - on_t;
    // reference uses unconditional set() on the left side (align.cpp:713)
    Candid best{max_ed + 1, std::max((int64_t)m, (int64_t)max_sc) + 1,
                w + 1, 0, false};
    if (ed <= max_ed) best = Candid{ed, clip, indel, score, true};
    out[0] = best.ed;
    out[1] = best.sclen;
    out[2] = best.indel;
    out[3] = score;
}

}  // extern "C"
