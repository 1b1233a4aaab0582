// K2 seed_scan: exact backward search of every (query, part) lane.
//
// Replaces sahara_tpu/engine/seedverify.py::_seed_scan (with its per-step
// rank, engine/rank.py::rank_sym_word): the j-mer table lookup, then one
// single-symbol rank at both interval ends for each remaining char of the
// part.  Outputs lo and sz = max(hi - lo, 0) per lane.
//
// Bound on the H100: bytes from HBM on a dependent chain.  Each step ranks
// both interval ends, about 23 steps per 33-char part after a 10-char table
// skip; a rank reads a checkpoint and a bit-plane word of one 64 B occ row
// (for symbols 2-4 at sigma = 6 in different 32 B sectors), and a chunk's
// rows (~53 MB) outgrow the L2, so most steps fetch their row from HBM.
// Bytes moved are the distinct rows the lanes touch plus the table and
// query reads.
//
// Design: one thread per lane with the whole scan in a register loop, so a
// chunk's 49k lanes keep their row reads in flight together.  Past the first
// steps an interval spans fewer than 32 rows and an empty one has lo == hi,
// so both ends mostly fall in one occ row: rank_sym_pair then fetches that
// row's two words once for both ends (2 requests a step, not 4).  The
// part's chars are read backwards from 32-bit words, each loaded once, and
// the table code comes from the same words.  The block size balances the
// grid over the SMs.  Like the JAX scan, the loop never stops early: an
// empty interval keeps being ranked, so lo matches the reference even where
// sz == 0.

#include "launch.cuh"
#include "occ.cuh"
#include "query.cuh"

namespace {

constexpr int kMaxParts = 16;

struct Parts {
    int32_t off[kMaxParts];
    int32_t len[kMaxParts];
};

__global__ void seed_scan_kernel(const int32_t* __restrict__ occ16, const int32_t* __restrict__ c_arr,
                                 const int32_t* __restrict__ lut, int lut_j, const uint8_t* __restrict__ queries,
                                 int lanes, int m, Parts parts, int n_parts, int sigma, int32_t n,
                                 int32_t* __restrict__ lo_out, int32_t* __restrict__ sz_out) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= lanes) return;
    const int qi = t / n_parts;
    const int p = t - qi * n_parts;
    // select, not an indexed read: a dynamic index would copy the parameter
    // arrays to local memory
    int off = 0, len = 0;
#pragma unroll
    for (int i = 0; i < kMaxParts; ++i) {
        if (i == p) {
            off = parts.off[i];
            len = parts.len[i];
        }
    }
    sahara::BackStream chars(queries + static_cast<int64_t>(qi) * m + off + len - 1);

    int32_t lo = 0;
    int32_t hi = n;
    int s = 0;
    if (lut != nullptr) {
        // digits are (rank - 1) in consumption order, little-endian; ranks
        // outside 1..4 give a clamped (garbage) code, as in the reference
        int32_t code = 0;
        for (; s < lut_j; ++s) code += (chars.next(s + 1 < len) - 1) * (1 << (2 * s));
        const int32_t n_codes = 1 << (2 * lut_j);
        code = min(max(code, 0), n_codes - 1);
        lo = __ldg(lut + code);
        hi = __ldg(lut + code + n_codes);
    }
    for (; s < len; ++s) {
        const int c = min(chars.next(s + 1 < len), sigma - 1);
        const int32_t base = __ldg(c_arr + c);
        int32_t rank_lo, rank_hi;
        sahara::rank_sym_pair(occ16, lo, hi, c, sigma, rank_lo, rank_hi);
        lo = base + rank_lo;
        hi = base + rank_hi;
    }
    lo_out[t] = lo;
    sz_out[t] = max(hi - lo, 0);
}

}  // namespace

// parts_host: off[0..n_parts) then len[0..n_parts); lut may be null.
extern "C" int sahara_seed_scan(const void* occ16, const void* c_arr, const void* lut, int lut_j,
                                const void* queries, int64_t nq, int m, const int32_t* parts_host,
                                int n_parts, int sigma, int32_t n, void* lo, void* sz, void* stream) {
    if (n_parts < 1 || n_parts > kMaxParts) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t lanes = nq * n_parts;
    if (lanes <= 0) return 0;
    if (lanes >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);  // 32-bit lane index
    Parts parts{};
    for (int p = 0; p < n_parts; ++p) {
        parts.off[p] = parts_host[p];
        parts.len[p] = parts_host[n_parts + p];
    }
    const int block = sahara::balanced_block(lanes);
    const int grid = static_cast<int>((lanes + block - 1) / block);
    const auto s = static_cast<cudaStream_t>(stream);
    seed_scan_kernel<<<grid, block, 0, s>>>(
        static_cast<const int32_t*>(occ16), static_cast<const int32_t*>(c_arr), static_cast<const int32_t*>(lut),
        lut_j, static_cast<const uint8_t*>(queries), static_cast<int>(lanes), m, parts, n_parts, sigma, n,
        static_cast<int32_t*>(lo), static_cast<int32_t*>(sz));
    return static_cast<int>(cudaGetLastError());
}
