// Native host-side fast paths for speck_tpu_torch (a copy of
// speck_tpu/native/speck_native.cpp; plain C++, no change but comments).
//
// Fast MatrixMarket body tokenizer: the reference's .mtx parsing is C++
// (loadMTX, source/COO.cpp:52-164 of spECK) because istringstream
// per line is the bottleneck at 100M+ nnz. This is a from-scratch
// single-pass tokenizer over the already-read body buffer; header/size-line
// handling, validation, and symmetry expansion stay in Python.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC speck_native.cpp -o <library>
// (speck_tpu_torch/native/__init__.py builds it at first use)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cctype>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline const char* skip_ws_and_comments(const char* p, const char* end) {
    while (p < end) {
        if (*p == '%') {  // comment line: skip to newline
            while (p < end && *p != '\n') ++p;
        } else if (std::isspace(static_cast<unsigned char>(*p))) {
            ++p;
        } else {
            break;
        }
    }
    return p;
}

inline bool parse_uint(const char*& p, const char* end, unsigned int& out) {
    p = skip_ws_and_comments(p, end);
    if (p >= end || !std::isdigit(static_cast<unsigned char>(*p))) return false;
    std::uint64_t v = 0;
    while (p < end && std::isdigit(static_cast<unsigned char>(*p))) {
        v = v * 10 + static_cast<std::uint64_t>(*p - '0');
        ++p;
    }
    out = static_cast<unsigned int>(v);
    return true;
}

inline bool parse_double(const char*& p, const char* end, double& out) {
    p = skip_ws_and_comments(p, end);
    if (p >= end) return false;
    char* q = nullptr;
    out = std::strtod(p, &q);
    if (q == p) return false;
    p = q;
    return true;
}

}  // namespace

extern "C" {

// Parses `count` entries of `ncol` whitespace-separated fields each from
// `body`. ncol: 2 = pattern (r c), 3 = real (r c v), 4 = complex
// (r c re im; the real part is kept, matching loadMTX which streams one
// value). Returns the number of entries parsed (== count on success).
long long speck_mtx_parse(const char* body, long long len, long long count,
                          int ncol, unsigned int* rows, unsigned int* cols,
                          double* vals) {
    const char* p = body;
    const char* end = body + len;
    for (long long i = 0; i < count; ++i) {
        if (!parse_uint(p, end, rows[i])) return i;
        if (!parse_uint(p, end, cols[i])) return i;
        if (ncol >= 3) {
            if (!parse_double(p, end, vals[i])) return i;
        } else {
            vals[i] = 1.0;
        }
        if (ncol == 4) {
            double imag;
            if (!parse_double(p, end, imag)) return i;
        }
    }
    return count;
}

// Formats `count` entries as "r c v\n" (1-based ids, %.17g values — exact
// float64 round-trip) into `out`. ncol: 2 = pattern "r c\n", 3 = real.
// Returns bytes written, or -1 if `out_cap` is insufficient. The writer
// counterpart of the parser above; np.savetxt's per-row python loop is
// unusable at 1e8 nnz.
long long speck_mtx_format(const unsigned int* rows, const unsigned int* cols,
                           const double* vals, long long count, int ncol,
                           char* out, long long out_cap) {
    char* p = out;
    char* end = out + out_cap;
    for (long long i = 0; i < count; ++i) {
        if (end - p < 64) return -1;
        int n;
        if (ncol >= 3) {
            n = std::snprintf(p, static_cast<std::size_t>(end - p),
                              "%u %u %.17g\n", rows[i] + 1, cols[i] + 1,
                              vals[i]);
        } else {
            n = std::snprintf(p, static_cast<std::size_t>(end - p),
                              "%u %u\n", rows[i] + 1, cols[i] + 1);
        }
        if (n <= 0 || p + n >= end) return -1;
        p += n;
    }
    return static_cast<long long>(p - out);
}

// Counting-sort COO->CSR with ascending column ids within each row
// (duplicates kept, stable — matching the numpy lexsort fallback).
// The native counterpart of convert(CSR&, const COO&)
// (source/CSR.cpp:173-212 of spECK), which is C++ for the same
// reason: at 1e8+ nnz the conversion dominates .mtx load time once the
// tokenizer is fast. Counting sort by row is O(nnz) where the
// reference's global std::sort is O(nnz log nnz); the within-row column
// sorts run across hardware threads.
//
// vals are opaque `itemsize`-byte elements (4 = float32, 8 = float64).
// Returns 0 on success, -1 if any row id >= m.
long long speck_coo_to_csr(const unsigned int* row_ids,
                           const unsigned int* col_ids, const char* vals,
                           long long nnz, long long m, int itemsize,
                           unsigned int* row_offsets,
                           unsigned int* cols_out, char* vals_out) {
    // pass 1: per-row histogram -> exclusive scan
    std::memset(row_offsets, 0, sizeof(unsigned int) * (m + 1));
    for (long long i = 0; i < nnz; ++i) {
        if (row_ids[i] >= m) return -1;
        ++row_offsets[row_ids[i] + 1];
    }
    for (long long r = 0; r < m; ++r) row_offsets[r + 1] += row_offsets[r];

    // pass 2: stable placement by row
    std::vector<unsigned int> cursor(row_offsets, row_offsets + m);
    if (itemsize == 8) {
        const std::uint64_t* v = reinterpret_cast<const std::uint64_t*>(vals);
        std::uint64_t* o = reinterpret_cast<std::uint64_t*>(vals_out);
        for (long long i = 0; i < nnz; ++i) {
            unsigned int pos = cursor[row_ids[i]]++;
            cols_out[pos] = col_ids[i];
            o[pos] = v[i];
        }
    } else if (itemsize == 4) {
        const std::uint32_t* v = reinterpret_cast<const std::uint32_t*>(vals);
        std::uint32_t* o = reinterpret_cast<std::uint32_t*>(vals_out);
        for (long long i = 0; i < nnz; ++i) {
            unsigned int pos = cursor[row_ids[i]]++;
            cols_out[pos] = col_ids[i];
            o[pos] = v[i];
        }
    } else {
        for (long long i = 0; i < nnz; ++i) {
            unsigned int pos = cursor[row_ids[i]]++;
            cols_out[pos] = col_ids[i];
            std::memcpy(vals_out + static_cast<long long>(pos) * itemsize,
                        vals + i * static_cast<long long>(itemsize),
                        static_cast<std::size_t>(itemsize));
        }
    }

    // pass 3: within-row ascending-column sort, parallel over row chunks.
    // Rows already sorted (the common case for row-major .mtx files) are
    // detected and skipped.
    unsigned int nthreads = std::thread::hardware_concurrency();
    if (nthreads == 0) nthreads = 1;
    if (m < 4096 || nnz < (1 << 18)) nthreads = 1;
    auto sort_rows = [&](long long r_lo, long long r_hi) {
        std::vector<unsigned int> perm;
        std::vector<unsigned int> ctmp;
        std::vector<char> vtmp;
        for (long long r = r_lo; r < r_hi; ++r) {
            const long long lo = row_offsets[r], hi = row_offsets[r + 1];
            const long long len = hi - lo;
            if (len < 2 || std::is_sorted(cols_out + lo, cols_out + hi))
                continue;
            perm.resize(len);
            for (long long j = 0; j < len; ++j)
                perm[j] = static_cast<unsigned int>(j);
            const unsigned int* cbase = cols_out + lo;
            std::stable_sort(perm.begin(), perm.end(),
                             [cbase](unsigned int a, unsigned int b) {
                                 return cbase[a] < cbase[b];
                             });
            ctmp.assign(cols_out + lo, cols_out + hi);
            vtmp.assign(vals_out + lo * itemsize, vals_out + hi * itemsize);
            for (long long j = 0; j < len; ++j) {
                cols_out[lo + j] = ctmp[perm[j]];
                std::memcpy(vals_out + (lo + j) * itemsize,
                            vtmp.data() +
                                static_cast<long long>(perm[j]) * itemsize,
                            static_cast<std::size_t>(itemsize));
            }
        }
    };
    if (nthreads == 1) {
        sort_rows(0, m);
    } else {
        std::vector<std::thread> pool;
        const long long per = (m + nthreads - 1) / nthreads;
        for (unsigned int t = 0; t < nthreads; ++t) {
            long long lo = static_cast<long long>(t) * per;
            long long hi = std::min<long long>(m, lo + per);
            if (lo >= hi) break;
            pool.emplace_back(sort_rows, lo, hi);
        }
        for (auto& th : pool) th.join();
    }
    return 0;
}

}  // extern "C"
