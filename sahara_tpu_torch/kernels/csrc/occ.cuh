// Rank on the planar occ16 layout, shared by the rank-all and seed-scan kernels.
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

// Count of `sym` in bwt[0 : pos]: one checkpoint plus a masked popcount.
__device__ __forceinline__ int32_t rank_sym(const int32_t* __restrict__ occ16, int32_t pos,
                                            int sym, int sigma) {
    const int32_t* row = occ16 + static_cast<int64_t>(pos >> 5) * kRowInts;
    const int32_t ckpt = __ldg(row + sym);
    const uint32_t bits = static_cast<uint32_t>(__ldg(row + sigma + sym));
    const uint32_t mask = (1u << (pos & 31)) - 1u;
    return ckpt + __popc(bits & mask);
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

}  // namespace sahara
