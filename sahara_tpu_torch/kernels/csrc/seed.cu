// K2 seed_scan: exact backward search of every (query, part) lane.
//
// Replaces sahara_tpu/engine/seedverify.py::_seed_scan (with its per-step
// rank, engine/rank.py::rank_sym_word): the j-mer table lookup, then one
// single-symbol rank at both interval ends for each remaining char of the
// part.  Outputs lo and sz = max(hi - lo, 0) per lane.
//
// Bound on the H100: memory latency.  Each step is a dependent pair of
// random 64 B occ-row reads (lo and hi), about 23 steps per 33-char part
// after a 10-char table skip, so a lane is a pointer chase; bytes moved are
// lanes * (2 * steps * 64 B + table and query reads).
//
// Design: one thread per lane with the whole scan in a register loop, so the
// XLA version's one launch per step becomes one launch per chunk, and a
// chunk's 49k lanes keep ~100k row reads in flight to cover DRAM latency.
// Like the JAX scan, the loop never stops early: an empty interval keeps
// being ranked, so lo matches the reference even where sz == 0.

#include "occ.cuh"

namespace {

constexpr int kMaxParts = 16;

struct Parts {
    int32_t off[kMaxParts];
    int32_t len[kMaxParts];
};

__global__ void seed_scan_kernel(const int32_t* __restrict__ occ16, const int32_t* __restrict__ c_arr,
                                 const int32_t* __restrict__ lut, int lut_j,
                                 const uint8_t* __restrict__ queries, int64_t nq, int m, Parts parts,
                                 int n_parts, int sigma, int32_t n, int32_t* __restrict__ lo_out,
                                 int32_t* __restrict__ sz_out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= nq * n_parts) return;
    const uint8_t* q = queries + (t / n_parts) * m;
    const int p = static_cast<int>(t % n_parts);
    const int off = parts.off[p];
    const int len = parts.len[p];

    int32_t lo = 0;
    int32_t hi = n;
    int start = 0;
    if (lut != nullptr) {
        // digits are (rank - 1) in consumption order, little-endian; ranks
        // outside 1..4 give a clamped (garbage) code, as in the reference
        int32_t code = 0;
        for (int i = 0; i < lut_j; ++i) {
            code += (static_cast<int32_t>(q[off + len - 1 - i]) - 1) * (1 << (2 * i));
        }
        const int32_t n_codes = 1 << (2 * lut_j);
        code = min(max(code, 0), n_codes - 1);
        lo = __ldg(lut + code);
        hi = __ldg(lut + code + n_codes);
        start = lut_j;
    }
    for (int s = start; s < len; ++s) {
        const int c = min(static_cast<int>(q[off + len - 1 - s]), sigma - 1);
        const int32_t base = __ldg(c_arr + c);
        lo = base + sahara::rank_sym(occ16, lo, c, sigma);
        hi = base + sahara::rank_sym(occ16, hi, c, sigma);
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
    Parts parts{};
    for (int p = 0; p < n_parts; ++p) {
        parts.off[p] = parts_host[p];
        parts.len[p] = parts_host[n_parts + p];
    }
    constexpr int kThreads = 256;
    const int64_t blocks = (lanes + kThreads - 1) / kThreads;
    seed_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(occ16), static_cast<const int32_t*>(c_arr),
        static_cast<const int32_t*>(lut), lut_j, static_cast<const uint8_t*>(queries), nq, m, parts,
        n_parts, sigma, n, static_cast<int32_t*>(lo), static_cast<int32_t*>(sz));
    return static_cast<int>(cudaGetLastError());
}
