// K1 rank_all: all-sigma ranks at a batch of BWT positions.
//
// Replaces sahara_tpu/kernels/rank.py::rank_all_hbm (and computes the same
// function as rank_all_vmem): out[t, s] = occ[i >> 5, s]
// + popcount(occ[i >> 5, sigma + s] & ((1 << (i & 31)) - 1)) for i = idx[t].
//
// Bound on the H100: memory.  Each index reads one 64 B row at a random
// address of a table far larger than L2 (80 MB for a 40 Mbp text), so the
// work is n * (4 + 4 * sigma) bytes of streams plus each distinct row once
// against 3.35 TB/s, and in practice the DRAM latency of scattered rows.
//
// Design, for this card:
//   - each thread takes kPer positions, a warp kPer blocks of 32 adjacent
//     ones, and issues every row load of all of them before it uses any, so
//     a thread keeps kPer rows in flight;
//   - a row comes in as the ceil(2 sigma / 4) 16 B vectors the function
//     reads (3 of the 4 at sigma <= 6), through the non-coherent path
//     without allocating in L1 (no SM reads a row twice);
//   - L2 policies per stream: the rows evict last, so a row that random
//     positions meet again stays in L2 against the index and output
//     streams, which are read or written once and evict first;
//   - the output leaves coalesced: a warp writes its 32 x sigma block as
//     sigma whole 128 B lines after an in-register transpose (rank_io.cuh),
//     where the plain layout had each store instruction span 24 sectors.
// sigma is a template parameter, so the per-symbol loops unroll and the row
// stays in registers.  The TPU kernel's 8-row fold and per-row DMAs existed
// for Mosaic's lane tiling and have no counterpart here.

#include "launch.cuh"
#include "occ.cuh"
#include "rank_io.cuh"

namespace {

constexpr int kPer = 2;  // positions per thread (kept by measurement on the H100, PERF.md)

template <int SIGMA>
__global__ void rank_all_kernel(const int4* __restrict__ occ16, const int32_t* __restrict__ idx, int64_t n,
                                int32_t* __restrict__ out) {
    constexpr int kVecs = (2 * SIGMA + 3) / 4;
    const int lane = threadIdx.x & 31;
    const int64_t base = ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) * (32 * kPer);
    if (base >= n) return;  // whole warps only
    const uint64_t first = sahara::policy_evict_first();
    const uint64_t last = sahara::policy_evict_last();
    int32_t pos[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int64_t t = base + 32 * p + lane;
        pos[p] = t < n ? sahara::load_int(idx + t, first) : 0;  // row 0 stands in past the end
    }
    int4 v[kPer][kVecs];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int4* row = occ16 + static_cast<int64_t>(pos[p] >> 5) * (sahara::kRowInts / 4);
#pragma unroll
        for (int u = 0; u < kVecs; ++u) v[p][u] = sahara::load_int4(row + u, last);
    }
    const sahara::WarpTranspose<SIGMA> tp(lane);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int64_t block = base + 32 * p;
        if (block >= n) break;  // warp-uniform
        int32_t r[4 * kVecs];
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
            r[4 * u + 0] = v[p][u].x;
            r[4 * u + 1] = v[p][u].y;
            r[4 * u + 2] = v[p][u].z;
            r[4 * u + 3] = v[p][u].w;
        }
        const uint32_t mask = (1u << (pos[p] & 31)) - 1u;
        int32_t res[SIGMA];
#pragma unroll
        for (int s = 0; s < SIGMA; ++s) res[s] = r[s] + __popc(static_cast<uint32_t>(r[SIGMA + s]) & mask);
        const int rows = n - block < 32 ? static_cast<int>(n - block) : 32;
        tp.store(res, out + block * SIGMA, rows * SIGMA, first);
    }
}

template <int SIGMA>
void launch(const int4* occ16, const int32_t* idx, int64_t n, int32_t* out, cudaStream_t stream) {
    const int64_t threads = (n + 32 * kPer - 1) / (32 * kPer) * 32;
    const int block = sahara::balanced_block(threads);
    rank_all_kernel<SIGMA><<<static_cast<unsigned>((threads + block - 1) / block), block, 0, stream>>>(
        occ16, idx, n, out);
}

}  // namespace

extern "C" int sahara_rank_all(const void* occ16, const void* idx, int64_t n, int sigma, void* out,
                               void* stream) {
    if (n <= 0) return 0;
    const auto* o = static_cast<const int4*>(occ16);
    const auto* x = static_cast<const int32_t*>(idx);
    auto* y = static_cast<int32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (sigma) {
        case 2: launch<2>(o, x, n, y, s); break;
        case 3: launch<3>(o, x, n, y, s); break;
        case 4: launch<4>(o, x, n, y, s); break;
        case 5: launch<5>(o, x, n, y, s); break;
        case 6: launch<6>(o, x, n, y, s); break;
        case 7: launch<7>(o, x, n, y, s); break;
        case 8: launch<8>(o, x, n, y, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
