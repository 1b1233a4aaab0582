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

// bad_mask_kernel (K2m): the queries whose table-covered part suffixes hold
// a rank the j-mer table cannot encode (outside 1..4, such as an N).  It
// replaces a numpy pass on the host, sahara_tpu/engine/seedverify.py:114
// `seed_bad_mask` (no Pallas kernel): it reads the copy of the query matrix
// that the driver uploads anyway, so the host never scans the reads.
//
// Bound on the H100: bytes from HBM.  Only ~30 of a 100-char row's bytes
// are covered, but no gap between them spans a 32 B sector, so every
// sector of the matrix is fetched: nq * m bytes in, nq bytes out.
//
// Design: a warp takes 32 consecutive rows, one contiguous span of 32 * m
// bytes, and reads it in aligned 16 B chunks, lane after lane (each load
// instruction 512 contiguous bytes, whatever m is).  A lane tests the 16
// bytes of a chunk at once (4 words, SWAR); only a chunk that holds a byte
// outside 1..4 maps its bytes to rows and columns and looks up which
// columns are covered (a bitmap of the columns in shared memory, built by
// the block).  The warp ORs its lanes' 32-bit row masks once and each lane
// writes its row's flag: no memset, no atomic, every row written.

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

// The 4-bit mask of the bytes of w outside 1..4.
__device__ __forceinline__ uint32_t bad_bytes(uint32_t w) {
    const uint32_t low = w & 0x7F7F7F7Fu;
    // a byte's high bit: set where it is >= 128, its low 7 bits >= 5, or it is 0;
    // low + 0x7B / 0x7F never carry into the next byte
    const uint32_t hi = (w | (low + 0x7B7B7B7Bu) | ~(low + 0x7F7F7F7Fu)) & 0x80808080u;
    // gather bits 0, 8, 16, 24 of hi >> 7 at bits 21..24 (no two products overlap)
    return (((hi >> 7) * 0x00204081u) >> 21) & 0xFu;
}

struct Ends {
    int32_t end[kMaxParts];  // each part's end column; its covered window is [end - lut_j, end)
};

__global__ void bad_mask_kernel(const uint8_t* __restrict__ queries, int64_t nq, int m, Ends ends, int n_parts,
                                int lut_j, uint8_t* __restrict__ out) {
    extern __shared__ uint32_t covered[];  // bit c: column c is table-covered; (m >> 5) + 2 words
    const int words = (m >> 5) + 2;
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
        uint32_t bits = 0;
#pragma unroll
        for (int p = 0; p < kMaxParts; ++p) {
            if (p < n_parts) {
                const int lo = max(ends.end[p] - lut_j - 32 * w, 0);
                const int hi = min(ends.end[p] - 32 * w, 32);
                if (hi > lo) bits |= (0xFFFFFFFFu >> (32 - (hi - lo))) << lo;
            }
        }
        covered[w] = bits;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int64_t row0 = ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) << 5;
    if (row0 >= nq) return;  // the whole warp
    const int rows = nq - row0 < 32 ? static_cast<int>(nq - row0) : 32;
    const uint8_t* first = queries + row0 * m;
    // aligned chunks from the one that holds the span's first byte to the one
    // that holds its last: an aligned 16 B chunk never crosses a page
    const uint4* chunks = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(first) & ~uintptr_t{15});
    const int head = static_cast<int>(first - reinterpret_cast<const uint8_t*>(chunks));
    const int n_chunks = (head + rows * m + 15) >> 4;
    // (row, column) in the span of the lane's chunk's first byte, f = 16 t - head (floor division)
    const int f = 16 * lane - head;
    int r = f >= 0 ? f / m : -((m - 1 - f) / m);
    int c = f - r * m;
    const int step_r = 512 / m;  // a lane's next chunk lies 32 chunks on
    const int step_c = 512 - step_r * m;
    uint32_t bad_rows = 0;  // bit i: row row0 + i is bad
    for (int t = lane; t < n_chunks; t += 32) {
        const uint4 v = __ldg(chunks + t);
        const uint32_t bad = bad_bytes(v.x) | bad_bytes(v.y) << 4 | bad_bytes(v.z) << 8 | bad_bytes(v.w) << 12;
        if (bad != 0) {
            // the chunk's bytes row by row: n of row rr from column cc, then the next row from column 0
            for (int b = 0, rr = r, cc = c; b < 16; ++rr, cc = 0) {
                const int n = min(16 - b, m - cc);
                if (rr >= 0 && rr < rows) {
                    const uint32_t cov = __funnelshift_r(covered[cc >> 5], covered[(cc >> 5) + 1], cc & 31);
                    if ((bad >> b) & cov & ((1u << n) - 1)) bad_rows |= 1u << rr;
                }
                b += n;
            }
        }
        r += step_r;
        c += step_c;
        if (c >= m) {
            c -= m;
            ++r;
        }
    }
    bad_rows = __reduce_or_sync(0xFFFFFFFFu, bad_rows);
    if (lane < rows) out[row0 + lane] = static_cast<uint8_t>((bad_rows >> lane) & 1u);
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

// ends_host: each part's end column (off + len); every part holds lut_j >= 1
// chars.  out: bool[nq].
extern "C" int sahara_seed_bad_mask(const void* queries, int64_t nq, int m, const int32_t* ends_host, int n_parts,
                                    int lut_j, void* out, void* stream) {
    const size_t smem = static_cast<size_t>((m >> 5) + 2) * sizeof(uint32_t);
    // the bitmap fits the default shared memory, so a warp's 32 * m bytes fit an int
    if (n_parts < 1 || n_parts > kMaxParts || lut_j < 1 || m < 1 || smem > 48 * 1024) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (nq <= 0) return 0;
    Ends ends{};
    for (int p = 0; p < n_parts; ++p) ends.end[p] = ends_host[p];
    constexpr int kBlock = 256;
    const int64_t grid = ((nq + 31) / 32 * 32 + kBlock - 1) / kBlock;
    if (grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    bad_mask_kernel<<<static_cast<int>(grid), kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(queries), nq, m, ends, n_parts, lut_j, static_cast<uint8_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
