// K3 verify: banded minimal-span edit distance (or Hamming distance) of the
// full query at each candidate start.
//
// Replaces sahara_tpu/engine/seedverify.py::_gather_windows and the DP and
// Hamming body of _verify_core.  For candidate r and start offset d
// (S = 2k+1 starts under edit distance, 1 under Hamming) the text span starts
// at p = base[r] + d; dist[r, d] is the minimal-span distance of query
// q_of[r] against text[p ...], or INF.  Text positions outside [0, n) and
// sentinels (rank 0) can neither match, substitute nor be deleted.
//
// Bound on the H100 under edit distance: the integer instruction rate of the
// SM's ALU pipes.  A thread runs m dependent rows of a band of B = 2k+1
// cells; the bytes are small (a window of m + k nibbles and the query per
// candidate).  The Hamming entry (K3h) is described above its kernel.
//
// Edit design: one thread per (candidate, start), the 2k+1 starts of a candidate
// on adjacent threads (their window loads coalesce), k a template parameter
// (k <= 7), the a/b band rows and the B text chars under the band in
// registers, the deletion chain run left to right in registers.  Each thread
// first decides which loop it runs:
//   - fast: its window text[p, p + m + k) lies inside [0, n) and holds no
//     rank-0 nibble (nearly every candidate of a real reference).  Every
//     substitution costs (w != q) and every deletion 1, so the steady rows
//     carry no sentinel tests and no saturation, only the recurrence; the
//     first 8 rows, which hold every cell with j <= 1, are peeled and fully
//     unrolled, so the steady rows carry no j tests either.  The text comes
//     as one 32-bit word of 8 nibbles per 8 rows (a funnel shift aligns it),
//     the query as 4 chars per 32-bit load; 32-bit indices throughout.  The
//     result is saturated once, at the end: min(., INF) commutes with min
//     and with adding a non-negative constant, so it equals the per-row
//     saturated value, and no sum exceeds 2^21 + 2m.
//   - general: any other window runs a loop with per-position bounds and
//     sentinel tests, cells saturated at INF after each row.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kInf = 1 << 20;

__device__ __forceinline__ int text_at(const int32_t* __restrict__ text4, int64_t n, int64_t pos) {
    if (pos < 0 || pos >= n) return 0;
    const uint32_t word = static_cast<uint32_t>(__ldg(text4 + (pos >> 3)));
    return static_cast<int>((word >> (4 * (pos & 7))) & 0xFu);
}

// Any window, with per-position bounds and sentinel tests.
template <int K>
__device__ int edit_general(const int32_t* __restrict__ text4, int64_t n, const uint8_t* __restrict__ q, int m,
                            int64_t p) {
    constexpr int B = 2 * K + 1;
    int a[B], b[B], w[B];
#pragma unroll
    for (int c = 0; c < B; ++c) {
        a[c] = (c == K) ? 0 : kInf;  // row 0: only j == 0 is reachable
        b[c] = kInf;
        w[c] = text_at(text4, n, p - K + c);  // row 1
    }
    for (int i = 1; i <= m; ++i) {
        if (i > 1) {
#pragma unroll
            for (int c = 0; c < B - 1; ++c) w[c] = w[c + 1];
            w[B - 1] = text_at(text4, n, p + i + K - 1);
        }
        const int qc = q[i - 1];
        int an[B], bn[B];
#pragma unroll
        for (int c = 0; c < B; ++c) {
            const int j = i - K + c;
            const int sub = (w[c] == 0) ? kInf : (w[c] != qc);
            const int up_a = (c + 1 < B) ? a[c + 1] : kInf;
            const int up_b = (c + 1 < B) ? b[c + 1] : kInf;
            int cand = min(a[c] + sub, up_a + 1);
            if (j == 0) cand = i;
            if (j < 0) cand = kInf;
            an[c] = cand;
            bn[c] = (j <= 0) ? kInf : min(a[c] + sub, up_b + 1);
        }
#pragma unroll
        for (int c = 1; c < B; ++c) {
            const int j = i - K + c;
            const int del = (j == 1 || w[c] == 0) ? kInf : 1;
            an[c] = min(an[c], an[c - 1] + del);
        }
#pragma unroll
        for (int c = 0; c < B; ++c) {
            a[c] = min(an[c], kInf);
            b[c] = min(bn[c], kInf);
        }
    }
    int best = b[0];
#pragma unroll
    for (int c = 1; c < B; ++c) best = min(best, b[c]);
    return best;
}

// True when text[p, p + len) lies inside [0, n) and holds no rank-0 nibble.
__device__ __forceinline__ bool clean_window(const int32_t* __restrict__ text4, int n, int p, int len) {
    if (p < 0 || static_cast<int64_t>(p) + len > n) return false;
    const int last = p + len - 1;
    uint32_t zero = 0;
    for (int wi = p >> 3; wi <= (last >> 3); ++wi) {
        uint32_t x = static_cast<uint32_t>(__ldg(text4 + wi));
        const int lo = (wi == (p >> 3)) ? (p & 7) : 0;
        const int hi = (wi == (last >> 3)) ? (last & 7) : 7;
        const uint32_t keep = (0xFFFFFFFFu << (4 * lo)) & (0xFFFFFFFFu >> (28 - 4 * hi));
        x |= ~keep & 0x11111111u;  // nibbles outside the window count as nonzero
        zero |= (x - 0x11111111u) & ~x & 0x88888888u;  // nonzero iff some nibble is 0
    }
    return zero == 0;
}

// Consecutive chars of a row of uint8 queries, 8 per call, read as aligned
// 32-bit words (each loaded once) and aligned by funnel shifts.  No word
// past the one holding the row's last char is read.
struct QueryStream {
    const uint32_t* words;
    int shift;  // 8 * (misalignment of the row start)
    int next;   // index of the next word to load
    int last;   // index of the word holding the row's last char
    uint32_t carry;

    __device__ __forceinline__ QueryStream(const uint8_t* q, int m) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(q);
        const uintptr_t a0 = a & ~uintptr_t{3};
        words = reinterpret_cast<const uint32_t*>(a0);
        shift = 8 * static_cast<int>(a & 3);
        last = static_cast<int>(((a + m - 1) & ~uintptr_t{3}) - a0) >> 2;
        carry = __ldg(words);
        next = 1;
    }

    // chars 8g .. 8g + 7 of the row (g counts calls): bytes of lo, then hi
    __device__ __forceinline__ void take8(uint32_t& lo, uint32_t& hi) {
        const uint32_t w1 = __ldg(words + min(next, last));
        const uint32_t w2 = __ldg(words + min(next + 1, last));
        lo = __funnelshift_r(carry, w1, shift);
        hi = __funnelshift_r(w1, w2, shift);
        carry = w2;
        next += 2;
    }
};

__device__ __forceinline__ int byte_of(uint32_t x, int b) {
    return static_cast<int>(__byte_perm(x, 0u, 0x4440u | static_cast<unsigned>(b)));
}

// One row of the fast loop: shift the entering text char `tc` into the band
// and advance a and b by query char `qc`.  EDGE rows (the peeled first 8,
// i a compile-time constant once unrolled) apply the boundary cases of
// j = i - K + c <= 1; steady rows have none.  No saturation: see the top.
template <int K, bool EDGE>
__device__ __forceinline__ void fast_row(int (&a)[2 * K + 1], int (&b)[2 * K + 1], int (&w)[2 * K + 1], int tc,
                                         int qc, int i) {
    constexpr int B = 2 * K + 1;
#pragma unroll
    for (int c = 0; c < B - 1; ++c) w[c] = w[c + 1];
    w[B - 1] = tc;
    int an[B], bn[B];
#pragma unroll
    for (int c = 0; c < B; ++c) {
        const int t = a[c] + (w[c] != qc);
        if (EDGE) {
            const int j = i - K + c;
            int cand = min(t, (c + 1 < B ? a[c + 1] : kInf) + 1);
            if (c > 0) cand = min(cand, an[c - 1] + (j == 1 ? kInf : 1));
            if (j == 0) cand = i;
            if (j < 0) cand = kInf;
            an[c] = cand;
            bn[c] = (j <= 0) ? kInf : min(t, (c + 1 < B ? b[c + 1] : kInf) + 1);
        } else {
            // min(diagonal + sub, up + 1, left + 1)
            if (c == 0 && B > 1) {
                an[c] = min(t, a[c + 1] + 1);
            } else if (c + 1 < B) {
                an[c] = min(t, min(a[c + 1], an[c - 1]) + 1);
            } else if (c > 0) {
                an[c] = min(t, an[c - 1] + 1);
            } else {
                an[c] = t;
            }
            bn[c] = (c + 1 < B) ? min(t, b[c + 1] + 1) : t;
        }
    }
#pragma unroll
    for (int c = 0; c < B; ++c) {
        a[c] = an[c];
        b[c] = bn[c];
    }
}

// The fast loop for a clean window (clean_window(text4, n, p, m + K)).
template <int K>
__device__ int edit_fast(const int32_t* __restrict__ text4, int n, const uint8_t* __restrict__ q, int m, int p) {
    constexpr int B = 2 * K + 1;
    const int last_word = (n - 1) >> 3;
    int a[B], b[B], w[B];
#pragma unroll
    for (int c = 0; c < B; ++c) {
        a[c] = (c == K) ? 0 : kInf;
        b[c] = kInf;
        w[c] = 0;  // cells with j <= 0 never read their char
    }
    // text[p + s] for s < K: the chars under cells j = 1 .. K of row 1
    // (before its shift); row i then brings in text[p + K + i - 1]
    const uint32_t head = __funnelshift_r(static_cast<uint32_t>(__ldg(text4 + (p >> 3))),
                                          static_cast<uint32_t>(__ldg(text4 + min((p >> 3) + 1, last_word))),
                                          4 * (p & 7));
#pragma unroll
    for (int s = 0; s < K; ++s) w[K + 1 + s] = static_cast<int>((head >> (4 * s)) & 0xFu);
    const int e0 = p + K;
    int tw = e0 >> 3;
    const int tshift = 4 * (e0 & 7);
    uint32_t tlo = static_cast<uint32_t>(__ldg(text4 + tw));
    QueryStream qs(q, m);

    // rows 8g + 1 .. 8g + 8 bring in the 8 chars from text[e0 + 8g] and read
    // query chars 8g .. 8g + 7
    uint32_t tx, qlo, qhi;
    auto take8 = [&]() {
        const uint32_t thi = static_cast<uint32_t>(__ldg(text4 + min(++tw, last_word)));
        tx = __funnelshift_r(tlo, thi, tshift);
        tlo = thi;
        qs.take8(qlo, qhi);
    };

    take8();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        if (r + 1 > m) break;
        fast_row<K, true>(a, b, w, static_cast<int>((tx >> (4 * r)) & 0xFu), byte_of(r < 4 ? qlo : qhi, r & 3),
                          r + 1);
    }
    int i0 = 8;  // rows done
    for (; i0 + 8 <= m; i0 += 8) {
        take8();
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            fast_row<K, false>(a, b, w, static_cast<int>((tx >> (4 * r)) & 0xFu), byte_of(r < 4 ? qlo : qhi, r & 3),
                               0);
        }
    }
    if (i0 < m) {
        take8();
#pragma unroll
        for (int r = 0; r < 7; ++r) {
            if (i0 + r + 1 > m) break;
            fast_row<K, false>(a, b, w, static_cast<int>((tx >> (4 * r)) & 0xFu), byte_of(r < 4 ? qlo : qhi, r & 3),
                               0);
        }
    }
    int best = b[0];
#pragma unroll
    for (int c = 1; c < B; ++c) best = min(best, b[c]);
    return min(best, kInf);
}

template <int K>
__global__ void edit_kernel(const int32_t* __restrict__ text4, int n, const uint8_t* __restrict__ queries, int m,
                            const int32_t* __restrict__ q_of, const int32_t* __restrict__ base, int threads,
                            int32_t* __restrict__ dist) {
    constexpr int S = 2 * K + 1;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= threads) return;
    const int r = t / S;
    const int p = base[r] + (t - r * S);
    const uint8_t* q = queries + static_cast<int64_t>(q_of[r]) * m;
    const bool fast = m > 0 && clean_window(text4, n, p, m + K);
    dist[t] = fast ? edit_fast<K>(text4, n, q, m, p) : edit_general<K>(text4, n, q, m, p);
}

// K3h, the Hamming entry.  Bound on the H100: bytes (a window of m nibbles
// and m query bytes a candidate); what held the first version back was
// latency, one thread a candidate with m dependent byte loads.  Design: G
// adjacent lanes a candidate (G = 1, 2, 4 or 8, by hamming_lanes: the most
// that keep the launch within kHammingThreadsPerSm threads an SM, at most
// twice the window's words), each taking a run of whole 8-char words of the
// window and summing by shuffles; blocks of kHammingBlock threads.
// A lane whose run lies inside [0, n) takes the fast loop: per 8 chars one
// funnel-shifted text word of 8 nibbles and two query words (QueryStream),
// the query bytes repacked to nibbles (exact while every byte is < 16, as
// ranks are; a lane that meets a larger byte reruns the general loop), one
// XOR and a popc of the nibble-nonzero mask for the mismatches, and a
// nibble-zero test for the sentinels, both masked to the window's last
// partial word.  Any other run takes a per-position loop like the first
// version's.

// Lanes a candidate under Hamming distance: 0 lets hamming_lanes pick them
// from the candidate count and m; 1, 2, 4 or 8 forces them.
constexpr int kHammingLanes = 0;
constexpr int kHammingThreadsPerSm = 1024;  // enough warps to hide the loads' latency
constexpr int kHammingBlock = 128;
constexpr int kSentinel = 1 << 16;          // a lane's sentinel flag above its mismatch count (<= 150)

// 8 query chars (bytes of lo, then hi, each < 16) as 8 nibbles, char i in nibble i.
__device__ __forceinline__ uint32_t nibbles8(uint32_t lo, uint32_t hi) {
    return __byte_perm(lo | (lo >> 4), hi | (hi >> 4), 0x6420u);
}

// Mismatches of query chars q[0, len) against text[pos, pos + len), which
// lies inside [0, n), plus kSentinel if a text char there is rank 0.  Sets
// `exact` false if a query byte is 16 or more (the repacking drops it).
__device__ int hamming_fast(const int32_t* __restrict__ text4, int n, const uint8_t* __restrict__ q, int pos,
                            int len, bool& exact) {
    const int last_word = (n - 1) >> 3;
    int tw = pos >> 3;
    const int tshift = 4 * (pos & 7);
    uint32_t tlo = static_cast<uint32_t>(__ldg(text4 + tw));
    QueryStream qs(q, len);
    int mism = 0;
    uint32_t zero = 0, high = 0;
    for (int c = 0; c < len; c += 8) {
        const uint32_t thi = static_cast<uint32_t>(__ldg(text4 + min(++tw, last_word)));
        uint32_t t = __funnelshift_r(tlo, thi, tshift);
        tlo = thi;
        uint32_t qlo, qhi;
        qs.take8(qlo, qhi);
        uint32_t keep = 0xFFFFFFFFu;
        const int rem = len - c;
        if (rem < 8) {  // the last partial word: chars past the run count for nothing
            keep = (1u << (4 * rem)) - 1u;
            qlo &= rem >= 4 ? 0xFFFFFFFFu : (1u << (8 * rem)) - 1u;
            qhi &= rem <= 4 ? 0u : (1u << (8 * (rem - 4))) - 1u;
        }
        high |= qlo | qhi;
        const uint32_t x = t ^ nibbles8(qlo, qhi);
        const uint32_t y = x | (x >> 2);
        mism += __popc((y | (y >> 1)) & 0x11111111u & keep);  // nibbles that differ
        t |= ~keep & 0x11111111u;
        zero |= (t - 0x11111111u) & ~t & 0x88888888u;  // nonzero iff some nibble is 0
    }
    exact = (high & 0xF0F0F0F0u) == 0;
    return mism | (zero ? kSentinel : 0);
}

// The same for query chars q[c0, c1) against text[p + c0, p + c1), any p.
__device__ int hamming_general(const int32_t* __restrict__ text4, int64_t n, const uint8_t* __restrict__ q,
                               int64_t p, int c0, int c1) {
    int mism = 0;
    bool sentinel = false;
    for (int i = c0; i < c1; ++i) {
        const int tc = text_at(text4, n, p + i);
        sentinel |= (tc == 0);
        mism += (tc != q[i]);
    }
    return mism | (sentinel ? kSentinel : 0);
}

template <int G>
__global__ void hamming_kernel(const int32_t* __restrict__ text4, int n, const uint8_t* __restrict__ queries, int m,
                               const int32_t* __restrict__ q_of, const int32_t* __restrict__ base, int n_cands,
                               int32_t* __restrict__ dist) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = t / G;
    if (r >= n_cands) return;  // whole groups leave: G divides 32
    const int lane = t % G;
    const int per = 8 * (((m + 7) / 8 + G - 1) / G);  // chars a lane
    const int c0 = min(per * lane, m), c1 = min(per * (lane + 1), m);
    const uint8_t* q = queries + static_cast<int64_t>(q_of[r]) * m;
    const int64_t p = base[r];
    int v = 0;
    if (c0 < c1) {
        bool exact = false;
        if (p + c0 >= 0 && p + c1 <= n) v = hamming_fast(text4, n, q + c0, static_cast<int>(p + c0), c1 - c0, exact);
        if (!exact) v = hamming_general(text4, n, q, p, c0, c1);
    }
    if (G > 1) {
        const unsigned group = ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1));
#pragma unroll
        for (int s = G / 2; s > 0; s >>= 1) v += __shfl_xor_sync(group, v, s);
    }
    if (lane == 0) dist[r] = v >= kSentinel ? kInf : v;
}

int hamming_lanes(int64_t n_cands, int m) {
    if (kHammingLanes) return kHammingLanes;
    const int words = (m + 7) / 8;
    const int64_t target = int64_t{sahara::sm_count()} * kHammingThreadsPerSm;
    int g = 1;
    while (g < 8 && g < words && n_cands * 2 * g <= target) g *= 2;
    return g;
}

template <int G>
void launch_hamming(const int32_t* text4, int n, const uint8_t* q, int m, const int32_t* q_of, const int32_t* base,
                    int n_cands, int32_t* dist, cudaStream_t stream) {
    const int threads = n_cands * G;
    hamming_kernel<G><<<(threads + kHammingBlock - 1) / kHammingBlock, kHammingBlock, 0, stream>>>(
        text4, n, q, m, q_of, base, n_cands, dist);
}

template <int K>
void launch_edit(const int32_t* text4, int n, const uint8_t* q, int m, const int32_t* q_of, const int32_t* base,
                 int threads, int32_t* dist, cudaStream_t stream) {
    const int block = sahara::balanced_block(threads);
    edit_kernel<K><<<(threads + block - 1) / block, block, 0, stream>>>(text4, n, q, m, q_of, base, threads, dist);
}

}  // namespace

// The lanes a candidate that a Hamming launch of n_cands candidates of m
// chars takes.
extern "C" int sahara_verify_hamming_lanes(int64_t n_cands, int m) { return hamming_lanes(n_cands, m); }

// dist: int32[n_cands, 2k+1] under edit distance, int32[n_cands] under Hamming.
extern "C" int sahara_verify(const void* text4, int64_t n, const void* queries, int m, const void* q_of,
                             const void* base, int64_t n_cands, int k, int edit, void* dist,
                             void* stream) {
    if (n_cands <= 0) return 0;
    const auto* tx = static_cast<const int32_t*>(text4);
    const auto* q = static_cast<const uint8_t*>(queries);
    const auto* qo = static_cast<const int32_t*>(q_of);
    const auto* ba = static_cast<const int32_t*>(base);
    auto* out = static_cast<int32_t*>(dist);
    auto s = static_cast<cudaStream_t>(stream);
    // both entries index the text, their threads and candidates in 32 bits
    if (n >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const int nn = static_cast<int>(n);
    if (!edit) {
        const int g = hamming_lanes(n_cands, m);
        if (n_cands * g >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
        const int nc = static_cast<int>(n_cands);
        switch (g) {
            case 1: launch_hamming<1>(tx, nn, q, m, qo, ba, nc, out, s); break;
            case 2: launch_hamming<2>(tx, nn, q, m, qo, ba, nc, out, s); break;
            case 4: launch_hamming<4>(tx, nn, q, m, qo, ba, nc, out, s); break;
            case 8: launch_hamming<8>(tx, nn, q, m, qo, ba, nc, out, s); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
        return static_cast<int>(cudaGetLastError());
    }
    if (n_cands * (2 * k + 1) >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = static_cast<int>(n_cands * (2 * k + 1));
    switch (k) {
        case 0: launch_edit<0>(tx, nn, q, m, qo, ba, threads, out, s); break;
        case 1: launch_edit<1>(tx, nn, q, m, qo, ba, threads, out, s); break;
        case 2: launch_edit<2>(tx, nn, q, m, qo, ba, threads, out, s); break;
        case 3: launch_edit<3>(tx, nn, q, m, qo, ba, threads, out, s); break;
        case 4: launch_edit<4>(tx, nn, q, m, qo, ba, threads, out, s); break;
        case 5: launch_edit<5>(tx, nn, q, m, qo, ba, threads, out, s); break;
        case 6: launch_edit<6>(tx, nn, q, m, qo, ba, threads, out, s); break;
        case 7: launch_edit<7>(tx, nn, q, m, qo, ba, threads, out, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
