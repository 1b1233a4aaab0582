// K4 rank_all_smem: all-sigma ranks with the whole occ16 table in shared memory.
//
// Replaces sahara_tpu/kernels/rank.py::rank_all_vmem (Pallas, table resident
// in VMEM) and computes K1's function: out[t, s] = occ[i >> 5, s]
// + popcount(occ[i >> 5, sigma + s] & ((1 << (i & 31)) - 1)) for i = idx[t].
//
// Bound on the H100: memory.  The indices and the output move through DRAM
// once, n * (4 + 4 * sigma) bytes; every block also reads the whole table
// from L2 once, w_rows * 64 bytes per SM.  Row reads then come from shared
// memory instead of DRAM, so the scattered-row latency of K1 goes away.
//
// Design: a persistent grid, one block of 1024 threads per SM.  Each block
// stages the table into dynamic shared memory with 16 B vector loads (the
// loop is bounded by the table's vector count, so the last block reads no
// further), synchronises once, then walks the indices grid-stride, one
// thread per index, reading its 64 B row as four 16 B shared loads.  sigma
// is a template parameter so the row stays in registers.  Rows are 64 B, so
// the eight threads of a quarter-warp that hit different rows in one bank
// group serialise: bank conflicts are the expected cost of random indices.
// The table must fit one block's opt-in shared memory (232,448 B on the
// H100: 3,632 rows, ~116k text positions); the wrapper refuses larger ones.

#include "occ.cuh"

namespace {

constexpr int kThreads = 1024;

template <int SIGMA>
__global__ void __launch_bounds__(kThreads) rank_smem_kernel(const int4* __restrict__ occ16, int32_t w_rows,
                                                             const int32_t* __restrict__ idx, int64_t n,
                                                             int32_t* __restrict__ out) {
    extern __shared__ int4 table[];
    const int32_t n_vec = w_rows * (sahara::kRowInts / 4);
    for (int32_t v = threadIdx.x; v < n_vec; v += blockDim.x) table[v] = __ldg(occ16 + v);
    __syncthreads();
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < n; t += stride) {
        const int32_t i = __ldg(idx + t);
        const int4* row = table + static_cast<int64_t>(i >> 5) * (sahara::kRowInts / 4);
        int32_t r[sahara::kRowInts];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const int4 x = row[v];
            r[4 * v + 0] = x.x;
            r[4 * v + 1] = x.y;
            r[4 * v + 2] = x.z;
            r[4 * v + 3] = x.w;
        }
        const uint32_t mask = (1u << (i & 31)) - 1u;
#pragma unroll
        for (int s = 0; s < SIGMA; ++s) {
            out[t * SIGMA + s] = r[s] + __popc(static_cast<uint32_t>(r[SIGMA + s]) & mask);
        }
    }
}

template <int SIGMA>
int launch(const int4* occ16, int32_t w_rows, const int32_t* idx, int64_t n, int32_t* out, cudaStream_t stream) {
    int dev = 0, sms = 0, smem_max = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t smem = static_cast<int64_t>(w_rows) * sahara::kRowInts * 4;
    if (smem > smem_max) return static_cast<int>(cudaErrorInvalidValue);
    // the attribute must be raised before the first launch above 48 KB
    err = cudaFuncSetAttribute(rank_smem_kernel<SIGMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t needed = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(needed < sms ? needed : sms);
    rank_smem_kernel<SIGMA><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(occ16, w_rows, idx, n, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sahara_rank_all_smem(const void* occ16, int32_t w_rows, const void* idx, int64_t n, int sigma,
                                    void* out, void* stream) {
    if (n <= 0) return 0;
    const auto* o = static_cast<const int4*>(occ16);
    const auto* x = static_cast<const int32_t*>(idx);
    auto* y = static_cast<int32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (sigma) {
        case 2: return launch<2>(o, w_rows, x, n, y, s);
        case 3: return launch<3>(o, w_rows, x, n, y, s);
        case 4: return launch<4>(o, w_rows, x, n, y, s);
        case 5: return launch<5>(o, w_rows, x, n, y, s);
        case 6: return launch<6>(o, w_rows, x, n, y, s);
        case 7: return launch<7>(o, w_rows, x, n, y, s);
        case 8: return launch<8>(o, w_rows, x, n, y, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
