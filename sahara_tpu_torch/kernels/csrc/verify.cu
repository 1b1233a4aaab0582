// K3 verify: banded minimal-span edit distance (or Hamming distance) of the
// full query at each candidate start.
//
// Replaces sahara_tpu/engine/seedverify.py::_gather_windows and the DP and
// Hamming body of _verify_core.  For candidate r and start offset d
// (S = 2k+1 starts under edit distance, 1 under Hamming) the text span starts
// at p = base[r] + d; dist[r, d] is the minimal-span distance of query
// q_of[r] against text[p ...], or INF.  Text positions outside [0, n) and
// sentinels (rank 0) can neither match, substitute nor be deleted.
//
// Bound on the H100: integer ALU work.  A thread runs m rows of a band of
// B = 2k+1 cells (about 9 integer operations a cell); the bytes are small
// (a window of m + 3k + 1 nibbles and the query per candidate).
//
// Design: one thread per (candidate, start), the B-wide a/b band rows and
// the B text chars under the band held in registers (k is a template
// parameter, k <= 7), the deletion chain run left to right in registers.
// The window is unpacked straight from the packed text as the band slides,
// one nibble per row, so no [R, wlen] window matrix is materialised.  The
// XLA version's Kogge-Stone prefix form of the chain (which capped it at
// B <= 16) is not needed.  Cells are saturated at INF after each row, which
// keeps every sum far below 2^31 and leaves every value < INF exact.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 20;

__device__ __forceinline__ int text_at(const int32_t* __restrict__ text4, int64_t n, int64_t pos) {
    if (pos < 0 || pos >= n) return 0;
    const uint32_t word = static_cast<uint32_t>(__ldg(text4 + (pos >> 3)));
    return static_cast<int>((word >> (4 * (pos & 7))) & 0xFu);
}

template <int K>
__global__ void edit_kernel(const int32_t* __restrict__ text4, int64_t n, const uint8_t* __restrict__ queries,
                            int m, const int32_t* __restrict__ q_of, const int32_t* __restrict__ base,
                            int64_t n_cands, int32_t* __restrict__ dist) {
    constexpr int B = 2 * K + 1;
    constexpr int S = 2 * K + 1;
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n_cands * S) return;
    const int64_t r = t / S;
    const int d = static_cast<int>(t % S);
    const uint8_t* q = queries + static_cast<int64_t>(q_of[r]) * m;
    // char of band cell c at row i is text[p + j - 1] with j = i - K + c
    const int64_t p = static_cast<int64_t>(base[r]) + d;

    int a[B], b[B], w[B];
#pragma unroll
    for (int c = 0; c < B; ++c) {
        a[c] = (c == K) ? 0 : kInf;  // row 0: only j == 0 is reachable
        b[c] = kInf;
        w[c] = text_at(text4, n, p - K + c);  // row 1
    }
    for (int i = 1; i <= m; ++i) {
        if (i > 1) {
#pragma unroll
            for (int c = 0; c < B - 1; ++c) w[c] = w[c + 1];
            w[B - 1] = text_at(text4, n, p + i + K - 1);
        }
        const int qc = q[i - 1];
        int an[B], bn[B];
#pragma unroll
        for (int c = 0; c < B; ++c) {
            const int j = i - K + c;
            const int sub = (w[c] == 0) ? kInf : (w[c] != qc);
            const int up_a = (c + 1 < B) ? a[c + 1] : kInf;
            const int up_b = (c + 1 < B) ? b[c + 1] : kInf;
            int cand = min(a[c] + sub, up_a + 1);
            if (j == 0) cand = i;
            if (j < 0) cand = kInf;
            an[c] = cand;
            bn[c] = (j <= 0) ? kInf : min(a[c] + sub, up_b + 1);
        }
#pragma unroll
        for (int c = 1; c < B; ++c) {
            const int j = i - K + c;
            const int del = (j == 1 || w[c] == 0) ? kInf : 1;
            an[c] = min(an[c], an[c - 1] + del);
        }
#pragma unroll
        for (int c = 0; c < B; ++c) {
            a[c] = min(an[c], kInf);
            b[c] = min(bn[c], kInf);
        }
    }
    int best = b[0];
#pragma unroll
    for (int c = 1; c < B; ++c) best = min(best, b[c]);
    dist[t] = best;
}

__global__ void hamming_kernel(const int32_t* __restrict__ text4, int64_t n, const uint8_t* __restrict__ queries,
                               int m, const int32_t* __restrict__ q_of, const int32_t* __restrict__ base,
                               int64_t n_cands, int32_t* __restrict__ dist) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= n_cands) return;
    const uint8_t* q = queries + static_cast<int64_t>(q_of[r]) * m;
    const int64_t p = base[r];
    int mism = 0;
    bool sentinel = false;
    for (int i = 0; i < m; ++i) {
        const int tc = text_at(text4, n, p + i);
        sentinel |= (tc == 0);
        mism += (tc != q[i]);
    }
    dist[r] = sentinel ? kInf : mism;
}

template <int K>
void launch_edit(const int32_t* text4, int64_t n, const uint8_t* q, int m, const int32_t* q_of,
                 const int32_t* base, int64_t n_cands, int32_t* dist, cudaStream_t stream) {
    constexpr int kThreads = 128;
    const int64_t threads = n_cands * (2 * K + 1);
    const int64_t blocks = (threads + kThreads - 1) / kThreads;
    edit_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(text4, n, q, m, q_of, base,
                                                                          n_cands, dist);
}

}  // namespace

// dist: int32[n_cands, 2k+1] under edit distance, int32[n_cands] under Hamming.
extern "C" int sahara_verify(const void* text4, int64_t n, const void* queries, int m, const void* q_of,
                             const void* base, int64_t n_cands, int k, int edit, void* dist,
                             void* stream) {
    if (n_cands <= 0) return 0;
    const auto* tx = static_cast<const int32_t*>(text4);
    const auto* q = static_cast<const uint8_t*>(queries);
    const auto* qo = static_cast<const int32_t*>(q_of);
    const auto* ba = static_cast<const int32_t*>(base);
    auto* out = static_cast<int32_t*>(dist);
    auto s = static_cast<cudaStream_t>(stream);
    if (!edit) {
        constexpr int kThreads = 128;
        const int64_t blocks = (n_cands + kThreads - 1) / kThreads;
        hamming_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(tx, n, q, m, qo, ba, n_cands, out);
        return static_cast<int>(cudaGetLastError());
    }
    switch (k) {
        case 0: launch_edit<0>(tx, n, q, m, qo, ba, n_cands, out, s); break;
        case 1: launch_edit<1>(tx, n, q, m, qo, ba, n_cands, out, s); break;
        case 2: launch_edit<2>(tx, n, q, m, qo, ba, n_cands, out, s); break;
        case 3: launch_edit<3>(tx, n, q, m, qo, ba, n_cands, out, s); break;
        case 4: launch_edit<4>(tx, n, q, m, qo, ba, n_cands, out, s); break;
        case 5: launch_edit<5>(tx, n, q, m, qo, ba, n_cands, out, s); break;
        case 6: launch_edit<6>(tx, n, q, m, qo, ba, n_cands, out, s); break;
        case 7: launch_edit<7>(tx, n, q, m, qo, ba, n_cands, out, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
