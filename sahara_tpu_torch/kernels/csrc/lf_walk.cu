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
// Bound on the H100: the bytes the function must move are the distinct
// sampled words and (row, symbol) occ words its rows visit, the sample slots,
// the rows in, and seq_id and pos out.  A walk is a chain of up to rate - 1
// dependent steps (the text layout puts a sampled row within rate - 1 steps
// of every hit row), but the chain does not set the time: each step loads a
// sampled word and words of an occ row at random in tables larger than L2,
// and the kernel runs at about the rate the memory system completes such
// scattered loads (a version that loaded a step's whole row beside its
// sampled word, one round trip a step, was the slowest measured; PERF.md).
// So the design cuts the loads and the L1 passes a step costs, not the round
// trips:
//   - two lanes walk a row (kWalkLanes): each loads 16 B vectors of the
//     row's bit planes from the one that holds plane 0, kVecs vectors a
//     batch between them (sigma <= 8: both plane vectors in one batch), so
//     a warp's load touches one 128 B line a walk, not one a vector;
//   - the sampled word is tested before the planes are loaded: a walk's
//     last row loads no planes;
//   - the lowest set plane by a shuffle between the lanes, then the
//     checkpoint and the bit word of the symbol by one load each (L1 hits
//     where the planes' sector holds them);
//   - the C array in shared memory.
// Rows are row_ints int32 wide at 64-bit offsets; the row width and sigma
// are runtime arguments.

#include "launch.cuh"

namespace {

// Design constants, each measured on the card beside the values tried (PERF.md).
constexpr int kWalkLanes = 2;   // lanes that walk one row
constexpr int kVecs = 4;        // 16 B vectors of bit planes a walk loads at once (at least one a lane)
constexpr int kNone = 1 << 30;  // no plane set

struct Out {
    const int32_t* __restrict__ sample_seq;
    const int32_t* __restrict__ sample_pos;
    int32_t n_samples;
    int32_t* __restrict__ seq;
    int32_t* __restrict__ pos;

    // The sample a sampled (or last) row ranks to, and its text position.
    __device__ __forceinline__ void put(int64_t t, int32_t row, int2 s, int steps) const {
        const int32_t slot = s.x + __popc(static_cast<uint32_t>(s.y) & ((1u << (row & 31)) - 1u));
        const int32_t at = min(max(slot, 0), n_samples - 1);
        seq[t] = __ldg(sample_seq + at);
        pos[t] = __ldg(sample_pos + at) + steps;
    }
};

// The bit planes kVecs 16 B vectors at a time, from the vector that holds
// plane 0 up to the one that holds the symbol's, spread over G lanes (the
// lowest plane by a shuffle reduction).
template <int G>
__global__ void lf_walk_kernel(const int32_t* __restrict__ occ, int row_ints, const int32_t* __restrict__ c_arr,
                               const int2* __restrict__ sampled, Out out, const int32_t* __restrict__ rows,
                               int64_t n_rows, int sigma, int rate) {
    constexpr int kPer = kVecs > G ? kVecs / G : 1;  // 16 B vectors a lane loads a batch
    __shared__ int32_t c_s[129];
    for (int i = threadIdx.x; i <= sigma; i += blockDim.x) c_s[i] = __ldg(c_arr + i);
    __syncthreads();
    const int64_t t = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
    if (t >= n_rows) return;  // whole groups: blocks are whole warps and G divides 32
    const int g = threadIdx.x % G;
    const unsigned group = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
    const int v0 = sigma >> 2, v1 = (2 * sigma + 3) >> 2;  // the vectors that hold planes
    int32_t row = __ldg(rows + t);
    int steps = 0;
    int2 s;
    for (;; ++steps) {
        const int32_t* r = occ + static_cast<int64_t>(row >> 5) * row_ints;
        const int4* r4 = reinterpret_cast<const int4*>(r);
        const int off = row & 31;
        s = __ldg(sampled + (row >> 5));
        if (steps == rate || ((static_cast<uint32_t>(s.y) >> off) & 1u)) break;
        int c = kNone;
        uint32_t word = 0;
        for (int vb = v0; vb < v1; vb += G * kPer) {
            int4 x[kPer];
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                const int v = vb + g + G * i;
                x[i] = v < v1 ? __ldg(r4 + v) : make_int4(0, 0, 0, 0);
            }
#pragma unroll
            for (int i = kPer - 1; i >= 0; --i) {  // downwards, so the lowest plane wins
                const int32_t w[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
                for (int u = 3; u >= 0; --u) {
                    const int p = 4 * (vb + g + G * i) + u - sigma;
                    if (p >= 0 && p < sigma && ((static_cast<uint32_t>(w[u]) >> off) & 1u)) {
                        c = p;
                        word = static_cast<uint32_t>(w[u]);
                    }
                }
            }
#pragma unroll
            for (int o = G / 2; o > 0; o >>= 1) c = min(c, __shfl_xor_sync(group, c, o));
            if (c != kNone) break;
        }
        if (c == kNone) {  // no plane set: symbol 0, as the reference's argmax
            c = 0;
            word = static_cast<uint32_t>(__ldg(r + sigma));
        } else if (G > 1) {  // the lane that found the plane may be another
            word = static_cast<uint32_t>(__ldg(r + sigma + c));
        }
        row = c_s[c] + __ldg(r + c) + __popc(word & ((1u << off) - 1u));
    }
    if (g == 0) out.put(t, row, s, steps);
}

}  // namespace

// occ: int32[W, row_ints] (16 B aligned); sampled: int32[W, 2]; rows: int32[n_rows].
extern "C" int sahara_lf_walk(const void* occ, const void* c_arr, const void* sampled, const void* sample_seq,
                              const void* sample_pos, int32_t n_samples, const void* rows, int64_t n_rows,
                              int row_ints, int sigma, int rate, void* seq_id, void* pos, void* stream) {
    if (n_rows <= 0) return 0;
    // 16 B vector loads: rows of a multiple of 4 int32 on a 16 B aligned table
    if (sigma < 1 || sigma > 128 || 2 * sigma > row_ints || row_ints % 4 || n_samples < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Out out{static_cast<const int32_t*>(sample_seq), static_cast<const int32_t*>(sample_pos), n_samples,
                  static_cast<int32_t*>(seq_id), static_cast<int32_t*>(pos)};
    const int64_t threads = n_rows * kWalkLanes;
    const int block = sahara::balanced_block(threads);
    lf_walk_kernel<kWalkLanes><<<static_cast<unsigned>((threads + block - 1) / block), block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(occ), row_ints, static_cast<const int32_t*>(c_arr),
        static_cast<const int2*>(sampled), out, static_cast<const int32_t*>(rows), n_rows, sigma, rate);
    return static_cast<int>(cudaGetLastError());
}
