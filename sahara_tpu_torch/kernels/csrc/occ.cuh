// Rank on the planar occ16 layout, shared by the rank-all, seed-scan, work-queue and frontier kernels.
//
// One row per 32 BWT positions, padded to 16 int32 (64 B, four 16 B vectors):
//   row[s]          absolute count of symbol s in bwt[0 : 32*word]   (s < sigma)
//   row[sigma + s]  bit-plane word of symbol s (bit b <=> bwt[32*word + b] == s)
//   the rest        zero.
// sigma <= 8, so a row always fits the 16 lanes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sahara {

constexpr int kRowInts = 16;

// Counts of `sym` in bwt[0 : lo] and bwt[0 : hi]: one checkpoint plus a
// masked popcount each.  When both ends fall in one row, its two words are
// fetched once and serve both (2 loads instead of 4).  Offsets are 32-bit:
// positions are below 2^31, so (pos >> 5) * 16 < 2^30.
__device__ __forceinline__ void rank_sym_pair(const int32_t* __restrict__ occ16, int32_t lo, int32_t hi, int sym,
                                              int sigma, int32_t& rank_lo, int32_t& rank_hi) {
    const int32_t* row = occ16 + (lo >> 5) * kRowInts;
    const int32_t ckpt_lo = __ldg(row + sym);
    const uint32_t bits_lo = static_cast<uint32_t>(__ldg(row + sigma + sym));
    int32_t ckpt_hi = ckpt_lo;
    uint32_t bits_hi = bits_lo;
    if ((hi >> 5) != (lo >> 5)) {
        const int32_t* row_hi = occ16 + (hi >> 5) * kRowInts;
        ckpt_hi = __ldg(row_hi + sym);
        bits_hi = static_cast<uint32_t>(__ldg(row_hi + sigma + sym));
    }
    rank_lo = ckpt_lo + __popc(bits_lo & ((1u << (lo & 31)) - 1u));
    rank_hi = ckpt_hi + __popc(bits_hi & ((1u << (hi & 31)) - 1u));
}

// The whole 64 B row as four 16 B vector loads.
__device__ __forceinline__ void load_row(const int32_t* __restrict__ occ16, int32_t pos,
                                         int32_t out[kRowInts]) {
    const int4* row = reinterpret_cast<const int4*>(occ16 + static_cast<int64_t>(pos >> 5) * kRowInts);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
        const int4 x = __ldg(row + v);
        out[4 * v + 0] = x.x;
        out[4 * v + 1] = x.y;
        out[4 * v + 2] = x.z;
        out[4 * v + 3] = x.w;
    }
}

// rank-all at lo and hi on one table: the occ rows' vectors that hold the sigma checkpoints and bit
// planes (at most eight 16 B loads) are all started first.
template <int SIGMA>
__device__ __forceinline__ void rank_pair(const int32_t* __restrict__ table, int32_t lo, int32_t hi,
                                          int32_t r_lo[SIGMA], int32_t r_hi[SIGMA]) {
    constexpr int kVecs = (2 * SIGMA + 3) / 4;
    const int4* a = reinterpret_cast<const int4*>(table + static_cast<int64_t>(lo >> 5) * kRowInts);
    const int4* b = reinterpret_cast<const int4*>(table + static_cast<int64_t>(hi >> 5) * kRowInts);
    int4 va[kVecs], vb[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
        va[v] = __ldg(a + v);
        vb[v] = __ldg(b + v);
    }
    int32_t ra[4 * kVecs], rb[4 * kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
        ra[4 * v] = va[v].x, ra[4 * v + 1] = va[v].y, ra[4 * v + 2] = va[v].z, ra[4 * v + 3] = va[v].w;
        rb[4 * v] = vb[v].x, rb[4 * v + 1] = vb[v].y, rb[4 * v + 2] = vb[v].z, rb[4 * v + 3] = vb[v].w;
    }
    const uint32_t mask_lo = (1u << (lo & 31)) - 1u, mask_hi = (1u << (hi & 31)) - 1u;
#pragma unroll
    for (int s = 0; s < SIGMA; ++s) {
        r_lo[s] = ra[s] + __popc(static_cast<uint32_t>(ra[SIGMA + s]) & mask_lo);
        r_hi[s] = rb[s] + __popc(static_cast<uint32_t>(rb[SIGMA + s]) & mask_hi);
    }
}

}  // namespace sahara
