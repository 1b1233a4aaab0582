// K1 rank_all: all-sigma ranks at a batch of BWT positions.
//
// Replaces sahara_tpu/kernels/rank.py::rank_all_hbm (and computes the same
// function as rank_all_vmem): out[t, s] = occ[i >> 5, s]
// + popcount(occ[i >> 5, sigma + s] & ((1 << (i & 31)) - 1)) for i = idx[t].
//
// Bound on the H100: memory.  Each index reads one 64 B row at a random
// address of a table far larger than L2 (80 MB for a 40 Mbp text), so the
// work is n * (4 + 64 + 4 * sigma) bytes against 3.35 TB/s, and in practice
// the DRAM latency of scattered rows.
//
// Design: one thread per index, so a warp keeps 32 independent row reads in
// flight and the card's occupancy hides their latency.  The row comes in as
// four 16 B vector loads through the read-only path; sigma is a template
// parameter so the per-symbol loop unrolls and the row stays in registers.
// The TPU kernel's 8-row fold and per-row DMAs existed for Mosaic's lane
// tiling and have no counterpart here.

#include "occ.cuh"

namespace {

template <int SIGMA>
__global__ void rank_all_kernel(const int32_t* __restrict__ occ16, const int32_t* __restrict__ idx,
                                int64_t n, int32_t* __restrict__ out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const int32_t i = idx[t];
    int32_t row[sahara::kRowInts];
    sahara::load_row(occ16, i, row);
    const uint32_t mask = (1u << (i & 31)) - 1u;
#pragma unroll
    for (int s = 0; s < SIGMA; ++s) {
        out[t * SIGMA + s] = row[s] + __popc(static_cast<uint32_t>(row[SIGMA + s]) & mask);
    }
}

template <int SIGMA>
void launch(const int32_t* occ16, const int32_t* idx, int64_t n, int32_t* out, cudaStream_t stream) {
    constexpr int kThreads = 256;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    rank_all_kernel<SIGMA><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(occ16, idx, n, out);
}

}  // namespace

extern "C" int sahara_rank_all(const void* occ16, const void* idx, int64_t n, int sigma, void* out,
                               void* stream) {
    if (n <= 0) return 0;
    const auto* o = static_cast<const int32_t*>(occ16);
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
