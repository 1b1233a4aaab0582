// Loads and stores of the rank-all kernels (K1 and K4): L2 cache policies
// for their streams and a warp-wide coalesced store of their output.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sahara {

// L2 policies: a stream read or written once is evicted first, the occ
// rows, which random positions meet again, last.
__device__ __forceinline__ uint64_t policy_evict_first() {
    uint64_t p;
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
    return p;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
    uint64_t p;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
    return p;
}

// Read-only loads that skip L1 (nothing is read twice by one SM) and carry
// an L2 policy.
__device__ __forceinline__ int32_t load_int(const int32_t* p, uint64_t policy) {
    int32_t v;
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
    return v;
}

__device__ __forceinline__ int4 load_int4(const int4* p, uint64_t policy) {
    int4 v;
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p), "l"(policy));
    return v;
}

// st.global of v at p where pred holds, with no branch around it.
__device__ __forceinline__ void store_int_if(int32_t* p, int32_t v, bool pred, uint64_t policy) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %3, 0;\n"
        "@p st.global.L2::cache_hint.s32 [%0], %1, %2;\n"
        "}\n" ::"l"(p),
        "r"(v), "l"(policy), "r"(static_cast<int>(pred))
        : "memory");
}

// gcd(s, 32) for 1 <= s <= 8, and its log2.
__host__ __device__ constexpr int gcd32(int s) { return s % 8 == 0 ? 8 : s % 4 == 0 ? 4 : s % 2 == 0 ? 2 : 1; }
__host__ __device__ constexpr int log2_gcd32(int s) { return s % 8 == 0 ? 3 : s % 4 == 0 ? 2 : s % 2 == 0 ? 1 : 0; }
// ceil(log2(s)), at least 1: binary stages of a rotation by less than s.
__host__ __device__ constexpr int rotate_stages(int s) { return s <= 2 ? 1 : s <= 4 ? 2 : 3; }

// v rotated by d (lane-dependent, 0 <= d < 2^STAGES) in binary stages of
// selects: left, v[k] <- v[k + d], or right, v[k] <- v[k - d], indices mod
// S.  Every index is a constant, so v stays in registers.
template <int S, int STAGES, bool LEFT>
__device__ __forceinline__ void rotate(int32_t (&v)[S], int d) {
#pragma unroll
    for (int b = 0; b < STAGES; ++b) {
        const bool on = (d >> b) & 1;
        int32_t w[S];
#pragma unroll
        for (int k = 0; k < S; ++k) w[k] = v[LEFT ? (k + (1 << b)) % S : ((k - (1 << b)) % S + S) % S];
#pragma unroll
        for (int k = 0; k < S; ++k) v[k] = on ? w[k] : v[k];
    }
}

// A warp holds a 32 x S block of results, lane L the S ints of row L, and
// writes it to out[0 : 32 S) row-major, round j storing ints [32 j, 32 j + 32):
// one whole 128 B line per round.  The int e = S L + r (row L, slot r) goes
// to lane e % 32, round e / 32.  In registers, with no shared memory
// (Catanzaro, Keller and Garland's decomposition of a transpose), with
// c = gcd(S, 32) and q = S / c:
//   1. lane L rotates its registers right by L / (32 / c), so int e sits in
//      register i(e) = (e % S + e / (32 S / c)) % S;
//   2. for each register i, lane L' takes register i from the lane holding
//      the int e = L' + 32 j whose i(e) is i: one shuffle a register, since
//      i(L' + 32 j) = (L' % S + pi(j)) % S with pi(j) = (32 j + j / q) % S a
//      permutation (the rotation of step 1 sees to that where S is even);
//   3. lane L' rotates its registers left by L' % S, after which round j
//      stores register pi(j), a constant.
// Every select has constant register indices, so nothing goes to local
// memory; the lane-dependent shuffle sources are computed once per thread.
template <int S>
__host__ __device__ constexpr int round_register(int j) {
    return (32 * j + j / (S / gcd32(S))) % S;
}

template <int S>
__host__ __device__ constexpr int register_round(int i) {
    int j = 0;
    while (round_register<S>(j) != i) ++j;
    return j;
}

template <int S>
struct WarpTranspose {
    int src[S];  // step 2: the lane register i comes from
    int lane;

    __device__ __forceinline__ explicit WarpTranspose(int lane_) : lane(lane_) {
        int32_t j[S];  // the round whose int lands in register i: pi^-1((i - L' % S) % S)
#pragma unroll
        for (int i = 0; i < S; ++i) j[i] = register_round<S>(i);
        rotate<S, rotate_stages(S), false>(j, lane % S);
#pragma unroll
        for (int i = 0; i < S; ++i) src[i] = (lane + 32 * j[i]) / S;
    }

    // Stores the warp's block at out (ints [0, valid) only: a partial last
    // block writes just its own rows).  Every lane of the warp must call it.
    __device__ __forceinline__ void store(const int32_t (&res)[S], int32_t* out, int valid, uint64_t policy) const {
        int32_t y[S];
#pragma unroll
        for (int i = 0; i < S; ++i) y[i] = res[i];
        rotate<S, log2_gcd32(S), false>(y, lane / (32 / gcd32(S)));
#pragma unroll
        for (int i = 0; i < S; ++i) y[i] = __shfl_sync(0xffffffffu, y[i], src[i]);
        rotate<S, rotate_stages(S), true>(y, lane % S);
#pragma unroll
        for (int j = 0; j < S; ++j) {
            store_int_if(out + 32 * j + lane, y[round_register<S>(j)], 32 * j + lane < valid, policy);
        }
    }
};

}  // namespace sahara
