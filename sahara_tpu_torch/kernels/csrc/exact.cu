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
// Bound on the H100: the bytes the function must move are the distinct
// (row, symbol) words the plain scan ranks at (checkpoint and bit word,
// 8 B), the queries and the outputs.  But each step's words lie in rows at
// random in a table larger than L2 (80 MB of occ16 rows for 40 Mbp; 119 MB
// of 256 B rows for the 15 M-symbol kmer text), and the kernel runs at about
// the rate the memory system completes such scattered loads: the loads a
// step issues and where they are cached set the pace, not the bytes, nor the
// chain's latency (all queries of a call are resident at once, and two
// queries a thread, interleaved, gained nothing; PERF.md).
//
// Design: one thread per query with the whole scan in a register loop; a
// step issues the two occ words of each end and nothing else of global
// memory but a query word every fourth step:
//   - past the first steps an interval spans few rows and an empty one has
//     lb == rb, so both ends mostly fall in one row: its two words are then
//     fetched once for both ends;
//   - the occ words of a step whose ends lie in two rows are cached in L1
//     (wide intervals: other queries share their rows), those of the other
//     steps are not (kOccL1 = 2): a row that one query alone visits would
//     only push the query words and the shared rows out of L1;
//   - the query's chars come from 32-bit words of global memory, one load
//     per 4 chars (query.cuh, as K2 reads them); the C array sits in shared
//     memory;
//   - a query whose last lut_j chars are all DNA ranks (1..4, below sigma)
//     starts at step lut_j from the j-mer table (index/jmer.py, the same
//     recursion from [0, n), so lb and rb are those of the scan, empty
//     intervals included); it skips the widest steps, whose ends lie in two
//     rows.  A window with $ (0), N (5) or a symbol at or above sigma takes
//     the full scan.
// Rows are row_ints int32 wide (16 for sigma <= 8, up to 256 for sigma =
// 128) at 64-bit offsets: (pos >> 5) * 256 passes 2^31 from pos = 2^28.  The
// row width and sigma are runtime arguments: a step only indexes by them.  A
// symbol at or above sigma is clamped to sigma - 1, as in the plain version,
// so no read leaves the row.

#include "launch.cuh"
#include "query.cuh"

namespace {

// Which occ words are cached in L1: 1 all, 0 none, 2 those of the steps whose
// ends lie in two rows (measured on the card beside the others; PERF.md).
constexpr int kOccL1 = 2;

// One occ word, through L1 or around it.
__device__ __forceinline__ int32_t occ_word(const int32_t* p, bool wide) {
    if (kOccL1 == 1 || (kOccL1 == 2 && wide)) return __ldg(p);
    int32_t v;
    asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__global__ void exact_kernel(const int32_t* __restrict__ occ, int row_ints, const int32_t* __restrict__ c_arr,
                             const int32_t* __restrict__ lut, int lut_j, const uint8_t* __restrict__ queries,
                             const int32_t* __restrict__ qlens, int64_t nq, int width, int sigma, int32_t n,
                             int32_t* __restrict__ lb_out, int32_t* __restrict__ len_out) {
    __shared__ int32_t c_s[129];
    for (int i = threadIdx.x; i <= sigma; i += blockDim.x) c_s[i] = __ldg(c_arr + i);
    __syncthreads();
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= nq) return;
    int left = min(max(__ldg(qlens + t), 0), width);  // chars still to consume
    int32_t lb = 0;
    int32_t rb = n;
    sahara::BackStream chars;
    if (left > 0) {
        chars = sahara::BackStream(queries + t * width + left - 1);
        if (lut != nullptr && left >= lut_j) {
            const unsigned digits = min(4, sigma - 1);  // table digits: ranks 1..digits
            sahara::BackStream probe = chars;
            int32_t code = 0;
            bool ok = true;
            for (int s = 0; s < lut_j; ++s) {
                const unsigned d = static_cast<unsigned>(probe.next(s + 1 < left) - 1);
                ok &= d < digits;
                code |= static_cast<int32_t>(d & 3u) << (2 * s);
            }
            if (ok) {
                lb = __ldg(lut + code);
                rb = __ldg(lut + code + (1 << (2 * lut_j)));
                left -= lut_j;
                chars = probe;
            }
        }
    }
    for (; left > 0; --left) {
        const int c = min(chars.next(left > 1), sigma - 1);
        const bool wide = (rb >> 5) != (lb >> 5);
        const int32_t* row_lb = occ + static_cast<int64_t>(lb >> 5) * row_ints;
        const int32_t ckpt_lb = occ_word(row_lb + c, wide);
        const uint32_t bits_lb = static_cast<uint32_t>(occ_word(row_lb + sigma + c, wide));
        int32_t ckpt_rb = ckpt_lb;
        uint32_t bits_rb = bits_lb;
        if (wide) {
            const int32_t* row_rb = occ + static_cast<int64_t>(rb >> 5) * row_ints;
            ckpt_rb = occ_word(row_rb + c, wide);
            bits_rb = static_cast<uint32_t>(occ_word(row_rb + sigma + c, wide));
        }
        const int32_t base = c_s[c];
        lb = base + ckpt_lb + __popc(bits_lb & ((1u << (lb & 31)) - 1u));
        rb = base + ckpt_rb + __popc(bits_rb & ((1u << (rb & 31)) - 1u));
    }
    lb_out[t] = lb;
    len_out[t] = rb - lb;
}

}  // namespace

// queries: uint8[nq, width] left-aligned; occ: int32[W, row_ints]; lut:
// int32[2 * 4^lut_j] (lo | hi of every j-mer code) or null.
extern "C" int sahara_exact_search(const void* occ, const void* c_arr, const void* lut, int lut_j,
                                   const void* queries, const void* qlens, int64_t nq, int width, int row_ints,
                                   int sigma, int32_t n, void* lb, void* len, void* stream) {
    if (nq <= 0) return 0;
    if (sigma < 1 || 2 * sigma > row_ints || sigma > 128 || (lut != nullptr && (lut_j < 1 || lut_j > 15))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int block = sahara::balanced_block(nq);
    exact_kernel<<<static_cast<unsigned>((nq + block - 1) / block), block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(occ), row_ints, static_cast<const int32_t*>(c_arr),
        static_cast<const int32_t*>(lut), lut_j, static_cast<const uint8_t*>(queries),
        static_cast<const int32_t*>(qlens), nq, width, sigma, n, static_cast<int32_t*>(lb),
        static_cast<int32_t*>(len));
    return static_cast<int>(cudaGetLastError());
}
