// Native host-side batched seed lookup for circminer-tpu.
//
// The k-mer index ((hv, checksum, pos)-sorted entry table with the window
// hash stored per entry, see circminer_tpu/index/build.py) lives in host
// RAM; lookup is a memory-latency-bound pointer workload (composite binary
// search over (hv, checksum)), the same access pattern as the reference's
// getCandidates + checksum bisect (src/mrsfast/HashTable.c:1093-1098,
// src/match_read.cpp:54-110) minus the dense bucket table (1 GiB/contig).
// One call resolves a whole read batch across std::thread workers; the
// gathered seed-position tensors then ship to the TPU for the batched
// chain DP.
//
// Build: g++ -O3 -shared -fPIC -pthread lookup_kernels.cpp -o liblookup.so

#include <cstdint>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// first index in [lo, hi) with (hv[i], cv[i]) >= (or >) (hv_t, cv_t)
inline int64_t bisect2(const int32_t* hvs, const int16_t* cvs,
                       int64_t lo, int64_t hi,
                       int32_t hv_t, int32_t cv_t, bool right) {
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        bool go_right = hvs[mid] < hv_t ||
            (hvs[mid] == hv_t &&
             (right ? cvs[mid] <= cv_t : cvs[mid] < cv_t));
        if (go_right) lo = mid + 1; else hi = mid;
    }
    return lo;
}

}  // namespace

extern "C" {

// Batched split_match_hash (match_read.cpp:270-286): non-overlapping k-mers
// (stride k) per read; per k-mer the window hash picks a bucket and the
// checksum range is bisected.  Outputs are compact [B, NL] (no odd slots).
// high[b] counts non-overlapping k-mers whose occupancy exceeded seed_lim.
//
// prefix_starts (optional, else null): int64[4^p + 1] entry offsets of each
// 2p-bit hv prefix (prefix_shift = 2*(w - p)).  It narrows the composite
// bisect from the full table (~26 random cache misses at chr21 scale) to a
// handful of entries sharing the prefix — the cheap, size-proportional
// replacement for the reference's dense 1 GiB bucket table
// (HashTable.c:769-839).
void batch_lookup(const int8_t* reads, const int32_t* lens,
                  int32_t B, int32_t L,
                  const int32_t* entry_hv,
                  const int16_t* entry_checksum,
                  int64_t n_entries,
                  const int64_t* prefix_starts, int32_t prefix_shift,
                  int32_t k, int32_t cs_len, int32_t NL, int32_t seed_lim,
                  int32_t* qpos, int32_t* start, int32_t* cnt, int32_t* high,
                  int32_t n_threads) {
    const int w = k - cs_len;
    auto worker = [&](int32_t b0, int32_t b1) {
        for (int32_t b = b0; b < b1; ++b) {
            const int8_t* rd = reads + (int64_t)b * L;
            const int32_t len = lens[b];
            int32_t hh = 0;
            for (int32_t s = 0; s < NL; ++s) {
                const int32_t off = s * k;
                int32_t* q = qpos + (int64_t)b * NL + s;
                int32_t* st = start + (int64_t)b * NL + s;
                int32_t* c = cnt + (int64_t)b * NL + s;
                *q = -1; *st = 0; *c = 0;
                if (off + k > len) continue;
                *q = off;
                // window hash + checksum; any N kills the k-mer
                int64_t hv = 0;
                bool ok = true;
                for (int32_t j = 0; j < w; ++j) {
                    int8_t base = rd[off + j];
                    if (base >= 4 || base < 0) { ok = false; break; }
                    hv = (hv << 2) | base;
                }
                if (!ok) continue;
                int32_t cv = 0;
                for (int32_t j = w; j < k; ++j) {
                    int8_t base = rd[off + j];
                    if (base >= 4 || base < 0) { ok = false; break; }
                    cv = (cv << 2) | base;
                }
                if (!ok) continue;
                int64_t blo = 0, bhi = n_entries;
                if (prefix_starts != nullptr) {
                    const int64_t pfx = hv >> prefix_shift;
                    blo = prefix_starts[pfx];
                    bhi = prefix_starts[pfx + 1];
                }
                const int64_t l = bisect2(entry_hv, entry_checksum,
                                          blo, bhi,
                                          (int32_t)hv, cv, false);
                const int64_t r = bisect2(entry_hv, entry_checksum,
                                          l, bhi,
                                          (int32_t)hv, cv, true);
                int64_t n = r - l;
                if (n > seed_lim) { ++hh; n = 0; }
                *st = (int32_t)l;
                *c = (int32_t)n;
            }
            high[b] = hh;
        }
    };
    if (n_threads <= 1 || B < 64) {
        worker(0, B);
        return;
    }
    std::vector<std::thread> ts;
    int32_t per = (B + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int32_t b0 = t * per, b1 = std::min(B, b0 + per);
        if (b0 >= b1) break;
        ts.emplace_back(worker, b0, b1);
    }
    for (auto& t : ts) t.join();
}

// Gather up to cap positions per (row, list) into a dense [R, NL, cap]
// int32 tensor (0-padded), the fixed-shape seed tensor the chain DP eats.
void batch_gather(const int32_t* entry_pos,
                  const int32_t* start, const int32_t* cnt,
                  int32_t R, int32_t NL, int32_t cap,
                  int32_t* pos_out, int32_t n_threads) {
    auto worker = [&](int32_t r0, int32_t r1) {
        for (int32_t r = r0; r < r1; ++r) {
            for (int32_t s = 0; s < NL; ++s) {
                const int64_t o = ((int64_t)r * NL + s);
                const int32_t c = std::min(cnt[o], cap);
                int32_t* dst = pos_out + o * cap;
                const int32_t* src = entry_pos + start[o];
                int32_t j = 0;
                for (; j < c; ++j) dst[j] = src[j];
                for (; j < cap; ++j) dst[j] = 0;
            }
        }
    };
    if (n_threads <= 1 || R < 64) {
        worker(0, R);
        return;
    }
    std::vector<std::thread> ts;
    int32_t per = (R + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int32_t r0 = t * per, r1 = std::min(R, r0 + per);
        if (r0 >= r1) break;
        ts.emplace_back(worker, r0, r1);
    }
    for (auto& t : ts) t.join();
}

}  // extern "C"
