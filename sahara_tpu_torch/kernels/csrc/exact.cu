// K6 exact_search: exact backward search of every query, on any occ row width.
//
// Replaces sahara_tpu/engine/exact.py::exact_search, a lax.scan over the
// padded query width whose every step runs engine/rank.py::rank_all at both
// interval ends (a whole row gathered for all sigma symbols, one kept).  A
// query starts from [0, n) and consumes its chars right to left over its own
// length: lb = C[c] + rank_c(lb), rb = C[c] + rank_c(rb).  Like the scan it
// never stops early, so lb matches the reference even for an empty interval;
// a zero-length query gives (0, n).  Outputs lb and len = rb - lb.
//
// Bound on the H100: bytes from HBM on a dependent chain.  A step needs only
// symbol c's checkpoint and bit word at each end, 8 B of one row, but the
// rows lie at random in a table far larger than L2 (80 MB of occ16 rows for
// 40 Mbp; 119 MB of 256 B rows for the 15 M-symbol kmer text), so a step
// waits on a DRAM fetch.  The bytes the function must move are the distinct
// (row, symbol) words its lanes rank at, the queries and the outputs.
//
// Design: one thread per query with the whole scan in a register loop, as K2
// does, so a batch keeps its row reads in flight together.  Past the first
// steps an interval spans few rows and an empty one has lb == rb, so both
// ends mostly fall in one row: its two words are then fetched once for both
// ends (the idea of occ.cuh's rank_sym_pair).  Rows are row_ints int32 wide
// (16 for sigma <= 8, up to 256 for sigma = 128) at 64-bit offsets: (pos >>
// 5) * 256 passes 2^31 from pos = 2^28.  The row width and sigma are runtime
// arguments, not template parameters: a step only indexes by them, so there
// is no per-symbol loop to unroll.  A symbol at or above sigma is clamped to
// sigma - 1, as in the plain version, so no read leaves the row.

#include "launch.cuh"

namespace {

__global__ void exact_kernel(const int32_t* __restrict__ occ, int row_ints, const int32_t* __restrict__ c_arr,
                             const uint8_t* __restrict__ queries, const int32_t* __restrict__ qlens, int64_t nq,
                             int width, int sigma, int32_t n, int32_t* __restrict__ lb_out,
                             int32_t* __restrict__ len_out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= nq) return;
    const uint8_t* q = queries + t * width;
    int32_t lb = 0;
    int32_t rb = n;
    for (int j = min(max(__ldg(qlens + t), 0), width) - 1; j >= 0; --j) {
        const int c = min(static_cast<int>(__ldg(q + j)), sigma - 1);
        const int32_t* row_lb = occ + static_cast<int64_t>(lb >> 5) * row_ints;
        const int32_t ckpt_lb = __ldg(row_lb + c);
        const uint32_t bits_lb = static_cast<uint32_t>(__ldg(row_lb + sigma + c));
        int32_t ckpt_rb = ckpt_lb;
        uint32_t bits_rb = bits_lb;
        if ((rb >> 5) != (lb >> 5)) {
            const int32_t* row_rb = occ + static_cast<int64_t>(rb >> 5) * row_ints;
            ckpt_rb = __ldg(row_rb + c);
            bits_rb = static_cast<uint32_t>(__ldg(row_rb + sigma + c));
        }
        const int32_t base = __ldg(c_arr + c);
        lb = base + ckpt_lb + __popc(bits_lb & ((1u << (lb & 31)) - 1u));
        rb = base + ckpt_rb + __popc(bits_rb & ((1u << (rb & 31)) - 1u));
    }
    lb_out[t] = lb;
    len_out[t] = rb - lb;
}

}  // namespace

// queries: uint8[nq, width] left-aligned; occ: int32[W, row_ints].
extern "C" int sahara_exact_search(const void* occ, const void* c_arr, const void* queries, const void* qlens,
                                   int64_t nq, int width, int row_ints, int sigma, int32_t n, void* lb, void* len,
                                   void* stream) {
    if (nq <= 0) return 0;
    if (sigma < 1 || 2 * sigma > row_ints) return static_cast<int>(cudaErrorInvalidValue);
    const int block = sahara::balanced_block(nq);
    exact_kernel<<<static_cast<unsigned>((nq + block - 1) / block), block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(occ), row_ints, static_cast<const int32_t*>(c_arr),
        static_cast<const uint8_t*>(queries), static_cast<const int32_t*>(qlens), nq, width, sigma, n,
        static_cast<int32_t*>(lb), static_cast<int32_t*>(len));
    return static_cast<int>(cudaGetLastError());
}
