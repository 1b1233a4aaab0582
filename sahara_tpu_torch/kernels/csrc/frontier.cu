// K8 frontier_step: one step of the frontier engine for every (query, search) lane in one launch.
//
// Replaces the step of sahara_tpu/engine/approx.py::scheme_search (:161-266), an XLA program of some
// forty ops that the lax.scan runs m + 1 (+ k for edit distance) times: the hit extraction, the tape
// and query lookups, two rank-alls per slot on the stacked occ table, the candidate children of every
// kind and their scatter-compaction into the next frontier.  Lane b = q * ns + s owns s_cap slots of six
// int32 planes (lb, lbr, sz, err, d, op; live where sz > 0) and h_cap hit slots (lb, sz, err).
//
// Design: one warp per lane, its slots 32 at a time.  A slot that consumed the query (d >= m) leaves the
// frontier, as a hit unless an edge bit says its span ends in a deleted character; the warp places hits
// by a ballot scan in slot order after the lane's earlier hits.  Every other live slot reads its tape
// word and query char, ranks both interval ends on its side's table (sahara::rank_pair: every 16 B load
// of the two occ rows in flight first) and forms one bit per child kind: match or substitution per
// symbol 1..sigma-1, and for edit distance a deletion per symbol and one insertion.  The reference
// orders children kind first, then slot; to keep that order, and with it the order in which a lane finds
// its hits (max_hits keeps the first ones), the warp takes two passes over the slots: the first counts
// each kind's children (a ballot per kind), the second recomputes each slot (its state and occ rows are
// in L1 or L2 by then) and writes each child at its kind's offset plus the ballot rank.  Slots past the
// lane's children get sz = 0 only.  Overflow of either buffer sets the lane's flag; the host reads the
// flags once per attempt.
//
// Bound on the H100: memory.  Per slot the sz word; per live slot its other 20 B, a tape word, a query
// char and two random 64 B occ rows of a table larger than L2; per child 24 B and per dead slot 4 B
// written.  Most slots are dead at the caps the engine starts from, so a warp's loads are few and
// scattered: the kernel runs at the rate those scattered loads complete, not at the HBM rate.

#include "occ.cuh"

namespace {

constexpr int kWarps = 4;  // lanes a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kOpIns = 1, kOpDel = 2, kEdgeL = 4, kEdgeR = 8, kEdges = kEdgeL | kEdgeR;

struct Params {
    const int32_t* occ16;
    const int32_t* c_arr;
    const int32_t* queries;  // int32[nq, m]
    const int32_t* tape;  // int32[ns, m]: side | lo << 1 | hi << 5 | qpos << 9
    const int32_t* in;  // int32[6, lanes, s_cap]
    int32_t* out;  // int32[6, lanes, s_cap]
    int32_t* hits;  // int32[3, lanes, h_cap]
    int32_t* hit_cnt;  // int32[lanes]
    int32_t* flags;  // int32[2, lanes]: frontier overflow, hit overflow
    int64_t lanes, rev_off;
    int m, ns, s_cap, h_cap;
};

// One slot: its state and, for a live slot that has not consumed the query, its ranks and the bit of
// each child kind it makes.
template <int SIGMA>
struct Slot {
    int32_t lb, lbr, sz, err, d, op, qc;
    int side;
    bool finished;
    uint32_t kinds;
    int32_t cnt[SIGMA], ext_lb[SIGMA], ext_lbr[SIGMA];
};

template <int SIGMA, bool EDIT>
__device__ __forceinline__ void load_slot(const Params& p, int64_t lane, int q, int s, int slot, Slot<SIGMA>& st) {
    st.sz = 0;
    st.finished = false;
    st.kinds = 0;
    if (slot >= p.s_cap) return;
    const int64_t plane = p.lanes * p.s_cap;
    const int32_t* in = p.in + lane * p.s_cap + slot;
    st.sz = in[2 * plane];
    if (st.sz <= 0) return;
    st.lb = in[0];
    st.lbr = in[plane];
    st.err = in[3 * plane];
    st.d = in[4 * plane];
    st.op = in[5 * plane];
    if (st.d >= p.m) {
        st.finished = (st.op & kEdges) == 0;
        return;
    }
    const int32_t word = __ldg(p.tape + static_cast<int64_t>(s) * p.m + st.d);
    st.side = word & 1;
    const int32_t lo_b = (word >> 1) & 0xF, hi_b = (word >> 5) & 0xF;
    st.qc = __ldg(p.queries + static_cast<int64_t>(q) * p.m + (word >> 9));
    const int32_t primary = st.side ? st.lbr : st.lb;
    const int32_t secondary = st.side ? st.lb : st.lbr;
    int32_t r_lo[SIGMA], r_hi[SIGMA];
    sahara::rank_pair<SIGMA>(p.occ16 + (st.side ? p.rev_off : 0) * sahara::kRowInts, primary, primary + st.sz,
                             r_lo, r_hi);
    int32_t prefix = 0;
#pragma unroll
    for (int j = 0; j < SIGMA; ++j) {
        st.cnt[j] = r_hi[j] - r_lo[j];
        const int32_t newp = __ldg(p.c_arr + j) + r_lo[j];
        const int32_t news = secondary + prefix;
        prefix += st.cnt[j];
        st.ext_lb[j] = st.side ? news : newp;
        st.ext_lbr[j] = st.side ? newp : news;
    }
    const int32_t last = st.op & 3;
#pragma unroll
    for (int j = 1; j < SIGMA; ++j) {
        const int32_t e2 = st.err + (st.qc != j ? 1 : 0);
        if (st.cnt[j] > 0 && e2 <= hi_b && e2 >= lo_b) st.kinds |= 1u << (j - 1);
        if (EDIT && st.cnt[j] > 0 && st.err + 1 <= hi_b && st.d > 0 && last != kOpIns) {
            st.kinds |= 1u << (SIGMA - 1 + j - 1);
        }
    }
    if (EDIT && st.err + 1 <= hi_b && st.err + 1 >= lo_b && last != kOpDel) st.kinds |= 1u << (2 * (SIGMA - 1));
}

// Child of kind C (a compile-time constant: the slot's arrays stay in registers) at frontier slot dest.
template <int SIGMA, int C>
__device__ __forceinline__ void write_child(const Params& p, int64_t lane, int dest, const Slot<SIGMA>& st) {
    const int64_t plane = p.lanes * p.s_cap;
    int32_t* out = p.out + lane * p.s_cap + dest;
    int32_t v[6];
    if (C < SIGMA - 1) {
        constexpr int j = C < SIGMA - 1 ? C + 1 : 1;
        v[0] = st.ext_lb[j], v[1] = st.ext_lbr[j], v[2] = st.cnt[j], v[3] = st.err + (st.qc != j ? 1 : 0);
        v[4] = st.d + 1, v[5] = st.op & (st.side == 0 ? kEdgeR : kEdgeL);
    } else if (C < 2 * (SIGMA - 1)) {
        constexpr int j = C < 2 * (SIGMA - 1) && C >= SIGMA - 1 ? C - (SIGMA - 1) + 1 : 1;
        v[0] = st.ext_lb[j], v[1] = st.ext_lbr[j], v[2] = st.cnt[j], v[3] = st.err + 1, v[4] = st.d;
        v[5] = kOpDel | (st.op & kEdges) | (st.side == 0 ? kEdgeL : kEdgeR);
    } else {
        v[0] = st.lb, v[1] = st.lbr, v[2] = st.sz, v[3] = st.err + 1, v[4] = st.d + 1;
        v[5] = kOpIns | (st.op & kEdges);
    }
#pragma unroll
    for (int f = 0; f < 6; ++f) out[f * plane] = v[f];
}

// Writes every child of kind C of this group of 32 slots, advancing that kind's next free slot.
template <int SIGMA, int C, int KINDS>
__device__ __forceinline__ void emit_kind(const Params& p, int64_t lane, const Slot<SIGMA>& st, unsigned below,
                                          int32_t next[KINDS]) {
    const bool mine = (st.kinds >> C) & 1u;
    const unsigned bal = __ballot_sync(kFull, mine);
    if (mine) {
        const int dest = next[C] + __popc(bal & below);
        if (dest < p.s_cap) write_child<SIGMA, C>(p, lane, dest, st);
    }
    next[C] += __popc(bal);
    if constexpr (C + 1 < KINDS) emit_kind<SIGMA, C + 1, KINDS>(p, lane, st, below, next);
}

template <int SIGMA, bool EDIT>
__global__ void __launch_bounds__(kThreads) frontier_kernel(const Params p) {
    constexpr int kKinds = EDIT ? 2 * (SIGMA - 1) + 1 : SIGMA - 1;
    const int64_t lane = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (lane >= p.lanes) return;  // the whole warp
    const int t = threadIdx.x & 31;
    const unsigned below = (1u << t) - 1u;
    const int q = static_cast<int>(lane / p.ns), s = static_cast<int>(lane % p.ns);
    const int64_t hplane = p.lanes * p.h_cap;
    const int32_t hit_base = p.hit_cnt[lane];

    // pass 1: hits in slot order, and the children of each kind
    int32_t found = 0;
    int32_t next[kKinds];
#pragma unroll
    for (int c = 0; c < kKinds; ++c) next[c] = 0;
    for (int g = 0; g < p.s_cap; g += 32) {
        Slot<SIGMA> st;
        load_slot<SIGMA, EDIT>(p, lane, q, s, g + t, st);
        const unsigned fin = __ballot_sync(kFull, st.finished);
        if (st.finished) {
            const int h = hit_base + found + __popc(fin & below);
            if (h < p.h_cap) {
                int32_t* hit = p.hits + lane * p.h_cap + h;
                hit[0] = st.lb;
                hit[hplane] = st.sz;
                hit[2 * hplane] = st.err;
            }
        }
        found += __popc(fin);
#pragma unroll
        for (int c = 0; c < kKinds; ++c) next[c] += __popc(__ballot_sync(kFull, (st.kinds >> c) & 1u));
    }
    // each kind's first slot: the children of the kinds before it
    int32_t total = 0;
#pragma unroll
    for (int c = 0; c < kKinds; ++c) {
        const int32_t n = next[c];
        next[c] = total;
        total += n;
    }
    if (t == 0) {
        p.hit_cnt[lane] = min(hit_base + found, p.h_cap);
        if (hit_base + found > p.h_cap) p.flags[p.lanes + lane] = 1;
        if (total > p.s_cap) p.flags[lane] = 1;
    }

    // pass 2: each child at its kind's next slot
    if (total > 0) {
        for (int g = 0; g < p.s_cap; g += 32) {
            Slot<SIGMA> st;
            load_slot<SIGMA, EDIT>(p, lane, q, s, g + t, st);
            if (__ballot_sync(kFull, st.kinds != 0) == 0) continue;
            emit_kind<SIGMA, 0, kKinds>(p, lane, st, below, next);
        }
    }
    int32_t* out_sz = p.out + 2 * p.lanes * p.s_cap + lane * p.s_cap;
    for (int slot = min(total, p.s_cap) + t; slot < p.s_cap; slot += 32) out_sz[slot] = 0;
}

template <int SIGMA>
int launch(bool edit, const Params& p, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((p.lanes + kWarps - 1) / kWarps);
    if (edit) {
        frontier_kernel<SIGMA, true><<<blocks, kThreads, 0, stream>>>(p);
    } else {
        frontier_kernel<SIGMA, false><<<blocks, kThreads, 0, stream>>>(p);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step of every lane: reads the frontier `state`, writes the next one to `out`, and updates the hit
// buffers, hit counts and overflow flags in place (shapes in Params).
extern "C" int sahara_frontier_step(const void* occ16, const void* c_arr, const void* queries, const void* tape,
                                    const void* state, void* out, void* hits, void* hit_cnt, void* flags,
                                    int64_t lanes, int sigma, int edit, int m, int ns, int64_t rev_off, int s_cap,
                                    int h_cap, void* stream) {
    if (lanes <= 0) return 0;
    if (m < 1 || ns < 1 || s_cap < 1 || h_cap < 1 || rev_off < 0 || lanes / ns > (1ll << 31) ||
        (lanes + kWarps - 1) / kWarps > 0x7FFFFFFFll) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p;
    p.occ16 = static_cast<const int32_t*>(occ16);
    p.c_arr = static_cast<const int32_t*>(c_arr);
    p.queries = static_cast<const int32_t*>(queries);
    p.tape = static_cast<const int32_t*>(tape);
    p.in = static_cast<const int32_t*>(state);
    p.out = static_cast<int32_t*>(out);
    p.hits = static_cast<int32_t*>(hits);
    p.hit_cnt = static_cast<int32_t*>(hit_cnt);
    p.flags = static_cast<int32_t*>(flags);
    p.lanes = lanes;
    p.rev_off = rev_off;
    p.m = m;
    p.ns = ns;
    p.s_cap = s_cap;
    p.h_cap = h_cap;
    auto st = static_cast<cudaStream_t>(stream);
    const bool e = edit != 0;
    switch (sigma) {
        case 2: return launch<2>(e, p, st);
        case 3: return launch<3>(e, p, st);
        case 4: return launch<4>(e, p, st);
        case 5: return launch<5>(e, p, st);
        case 6: return launch<6>(e, p, st);
        case 7: return launch<7>(e, p, st);
        case 8: return launch<8>(e, p, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
