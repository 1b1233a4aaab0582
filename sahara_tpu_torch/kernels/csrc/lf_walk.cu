// K7 lf_walk: the sampled LF walk of locate, on any occ row width.
//
// Replaces the sampled branch of sahara_tpu/engine/locate.py::lf_walk (with
// engine/rank.py::symbol_from_row, sampled_bit and sampled_rank): each SA row
// steps back by LF, row = C[c] + rank_c(row) with c the BWT symbol at row,
// until the row is sampled, at most `rate` steps (a fixed rate-trip loop in
// the reference, whose trips after the first sampled row change nothing).
// Then slot = rank of the row among the sampled rows, clamped to the samples,
// seq_id = sample_seq[slot] and pos = sample_pos[slot] + steps.  The symbol is
// the lowest plane whose bit is set at the row, 0 where none is (the argmax
// of the reference); exactly one is set at every row of the text.
//
// Bound on the H100: bytes from HBM on a dependent chain of up to rate - 1
// steps (the text layout puts a sampled row within rate - 1 steps of every
// hit row).  A step reads the row's sampled word (8 B) and the bit words of
// its occ row up to the symbol's plane, then one checkpoint; the rows lie at
// random in tables far larger than L2, so each step waits on DRAM.  The bytes
// the function must move are the distinct sampled words and occ bit words
// its rows visit, the rows in, and seq_id and pos out.
//
// Design: one thread per row, the walk in a register loop that stops at the
// first sampled row, so the rows of a call keep their fetches in flight
// together.  The bit words are read as 16 B vectors from the one holding
// plane 0 up to the one that holds the symbol's plane, and the rank reuses
// the bit word found.  Rows are row_ints int32 wide (16 for sigma <= 8, up
// to 256 for sigma = 128) at 64-bit offsets.  The row width and sigma are
// runtime arguments, not template parameters: the scan stops at the
// symbol's vector, so a fixed trip count would not unroll it either.

#include "launch.cuh"

namespace {

// The row one text position earlier: C[c] + rank_c(row).
__device__ __forceinline__ int32_t lf_step(const int32_t* __restrict__ occ, int row_ints,
                                           const int32_t* __restrict__ c_arr, int sigma, int32_t row) {
    const int32_t* r = occ + static_cast<int64_t>(row >> 5) * row_ints;
    const int4* r4 = reinterpret_cast<const int4*>(r);
    const int off = row & 31;
    int c = -1;
    uint32_t word = 0;
    for (int v = sigma >> 2; c < 0 && v < (2 * sigma + 3) >> 2; ++v) {
        const int4 x = __ldg(r4 + v);
        const int32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int u = 3; u >= 0; --u) {  // downwards, so the lowest plane of the vector wins
            const int p = 4 * v + u - sigma;
            if (p >= 0 && p < sigma && ((static_cast<uint32_t>(w[u]) >> off) & 1u)) {
                c = p;
                word = static_cast<uint32_t>(w[u]);
            }
        }
    }
    if (c < 0) {  // no plane set: symbol 0, as the reference's argmax
        c = 0;
        word = static_cast<uint32_t>(__ldg(r + sigma));
    }
    return __ldg(c_arr + c) + __ldg(r + c) + __popc(word & ((1u << off) - 1u));
}

__global__ void lf_walk_kernel(const int32_t* __restrict__ occ, int row_ints, const int32_t* __restrict__ c_arr,
                               const int2* __restrict__ sampled, const int32_t* __restrict__ sample_seq,
                               const int32_t* __restrict__ sample_pos, int32_t n_samples,
                               const int32_t* __restrict__ rows, int64_t n_rows, int sigma, int rate,
                               int32_t* __restrict__ seq_out, int32_t* __restrict__ pos_out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n_rows) return;
    int32_t row = __ldg(rows + t);
    int2 s = __ldg(sampled + (row >> 5));
    int steps = 0;
    for (; steps < rate && !((static_cast<uint32_t>(s.y) >> (row & 31)) & 1u); ++steps) {
        row = lf_step(occ, row_ints, c_arr, sigma, row);
        s = __ldg(sampled + (row >> 5));
    }
    const int32_t slot = s.x + __popc(static_cast<uint32_t>(s.y) & ((1u << (row & 31)) - 1u));
    const int32_t at = min(max(slot, 0), n_samples - 1);
    seq_out[t] = __ldg(sample_seq + at);
    pos_out[t] = __ldg(sample_pos + at) + steps;
}

}  // namespace

// occ: int32[W, row_ints] (16 B aligned); sampled: int32[W, 2]; rows: int32[n_rows].
extern "C" int sahara_lf_walk(const void* occ, const void* c_arr, const void* sampled, const void* sample_seq,
                              const void* sample_pos, int32_t n_samples, const void* rows, int64_t n_rows,
                              int row_ints, int sigma, int rate, void* seq_id, void* pos, void* stream) {
    if (n_rows <= 0) return 0;
    // 16 B vector loads: rows of a multiple of 4 int32 on a 16 B aligned table
    if (sigma < 1 || 2 * sigma > row_ints || row_ints % 4 || n_samples < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int block = sahara::balanced_block(n_rows);
    lf_walk_kernel<<<static_cast<unsigned>((n_rows + block - 1) / block), block, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(occ), row_ints, static_cast<const int32_t*>(c_arr),
        static_cast<const int2*>(sampled), static_cast<const int32_t*>(sample_seq),
        static_cast<const int32_t*>(sample_pos), n_samples, static_cast<const int32_t*>(rows), n_rows, sigma, rate,
        static_cast<int32_t*>(seq_id), static_cast<int32_t*>(pos));
    return static_cast<int>(cudaGetLastError());
}
