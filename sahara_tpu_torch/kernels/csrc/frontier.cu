// K8 frontier_step: one step of the frontier engine for every (query, search) lane in one launch.
//
// Replaces the step of sahara_tpu/engine/approx.py::scheme_search (:161-266), an XLA program of some
// forty ops that the lax.scan runs m + 1 (+ k for edit distance) times: the hit extraction, the tape
// and query lookups, two rank-alls per slot on the stacked occ table, the candidate children of every
// kind and their scatter-compaction into the next frontier.  Lane b = q * ns + s owns s_cap slots of six
// int32 planes (lb, lbr, sz, err, d, op) and h_cap hit slots (lb, sz, err); its live slots are the
// prefix 0 .. live[b] - 1, so a step reads and writes only those.  A search that pools lanes of several
// chunks gives each lane its own caps (caps[0 / 1, b], at most s_cap / h_cap, the buffers' widths).
//
// Design: a warp takes kWarpLanes consecutive lanes and lays their live slots out as one list, lane
// after lane (a scan of their live counts), 32 slots a round, one slot a thread; most lanes are empty
// and a live one holds one to a few dozen slots, so threads follow live slots, not lanes.  A slot that
// consumed the query (d >= m) leaves the frontier, as a hit unless an edge bit says its span ends in a
// deleted character.  Every other live slot loads its planes, then its tape word and its query char
// together (qt holds each lane's query chars in tape order, so both are indexed by d), then ranks both
// interval ends on its side's table (sahara::rank_pair: every 16 B load of the two occ rows in flight
// first), and forms one bit per child kind: match or substitution per symbol 1..sigma-1, and for edit
// distance a deletion per symbol and one insertion.  The reference orders a lane's children kind first,
// then slot, and its hits by slot; that order (max_hits keeps a query's first hits) needs every kind's
// count before the first write.  A ballot per kind, masked to each lane's run of threads (a segmented
// count), gives a slot its rank within its lane and kind; the thread of each lane keeps the lane's
// running counts and hands them out by shuffles.  A warp whose slots fit one round keeps each slot's
// ranks and kinds in registers between the counts and the writes, so its step is one pass over the live
// slots; a warp of a longer list (one in nine at the widest step of the bench workload) loads and ranks
// its rounds a second time to write.  Overflow of either buffer sets the lane's flag; the host reads
// the flags once per search.
//
// Bound on the H100: memory.  Per lane its live count; per live slot its 24 B, a tape word, a query char
// and two random 64 B occ rows of a table larger than L2; per child 24 B written.  The kernel runs at the
// rate the scattered loads of the live slots complete: the longest list of a warp sets its chain.

#include "occ.cuh"

namespace {

constexpr int kWarpLanes = 8;  // lanes a warp
constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kOpIns = 1, kOpDel = 2, kEdgeL = 4, kEdgeR = 8, kEdges = kEdgeL | kEdgeR;
static_assert(kWarpLanes >= 1 && kWarpLanes <= 32 && (kWarpLanes & (kWarpLanes - 1)) == 0, "lanes a warp");

struct Params {
    const int32_t* occ16;
    const int32_t* c_arr;
    const int8_t* qt;  // int8[lanes, m]: the lane's query char at each tape position
    const int32_t* tape;  // int32[ns, m]: side | lo << 1 | hi << 5 | qpos << 9
    const int32_t* in;  // int32[6, lanes, s_cap]
    const int32_t* in_live;  // int32[lanes]
    const int32_t* caps;  // int32[2, lanes]: each lane's s_cap and h_cap; null: s_cap and h_cap for all
    int32_t* out;  // int32[6, lanes, s_cap]
    int32_t* out_live;  // int32[lanes]
    int32_t* hits;  // int32[3, lanes, h_cap]
    int32_t* hit_cnt;  // int32[lanes]
    int32_t* flags;  // int32[2, lanes]: frontier overflow, hit overflow
    int64_t lanes, rev_off;
    int m, ns, s_cap, h_cap;  // s_cap, h_cap: the widths of a lane's slots and hits
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
__device__ __forceinline__ void load_slot(const Params& p, int64_t lane, int slot, bool valid, Slot<SIGMA>& st) {
    st.finished = false;
    st.kinds = 0;
    if (!valid) return;
    const int64_t plane = p.lanes * p.s_cap;
    const int32_t* in = p.in + lane * p.s_cap + slot;
    st.lb = __ldg(in);
    st.lbr = __ldg(in + plane);
    st.sz = __ldg(in + 2 * plane);
    st.err = __ldg(in + 3 * plane);
    st.d = __ldg(in + 4 * plane);
    st.op = __ldg(in + 5 * plane);
    if (st.d >= p.m) {
        st.finished = (st.op & kEdges) == 0;
        return;
    }
    const int32_t word = __ldg(p.tape + (lane % p.ns) * p.m + st.d);
    st.qc = __ldg(p.qt + lane * p.m + st.d);
    st.side = word & 1;
    const int32_t lo_b = (word >> 1) & 0xF, hi_b = (word >> 5) & 0xF;
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

// The threads that hold items first .. end - 1 of a warp's list in round r.
__device__ __forceinline__ unsigned run_of(int first, int end, int r) {
    const int lo = min(max(first - 32 * r, 0), 32), hi = min(max(end - 32 * r, 0), 32);
    if (lo >= hi) return 0;
    return (hi == 32 ? kFull : (1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// Writes every child of kind C of this round's slots, each at its lane's next free slot of that kind
// (held by the lane's thread `j`, handed out by a shuffle); the lane threads advance their counts.
template <int SIGMA, int C, int KINDS>
__device__ __forceinline__ void emit_kind(const Params& p, int64_t lane, int j, int s_lim, const Slot<SIGMA>& st,
                                          unsigned run, unsigned below, unsigned own_run, int32_t next[KINDS]) {
    const bool mine = (st.kinds >> C) & 1u;
    const unsigned bal = __ballot_sync(kFull, mine);
    if (bal != 0) {
        const int32_t base = __shfl_sync(kFull, next[C], j);
        if (mine) {
            const int dest = base + __popc(bal & run & below);
            if (dest < s_lim) write_child<SIGMA, C>(p, lane, dest, st);
        }
        next[C] += __popc(bal & own_run);
    }
    if constexpr (C + 1 < KINDS) emit_kind<SIGMA, C + 1, KINDS>(p, lane, j, s_lim, st, run, below, own_run, next);
}

template <int SIGMA, bool EDIT>
__global__ void __launch_bounds__(kThreads) frontier_kernel(const Params p) {
    constexpr int kKinds = EDIT ? 2 * (SIGMA - 1) + 1 : SIGMA - 1;
    const int64_t first_lane = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kWarpLanes;
    if (first_lane >= p.lanes) return;  // the whole warp
    const int t = threadIdx.x & 31;
    const unsigned below = (1u << t) - 1u;

    // thread t < kWarpLanes is lane first_lane + t's: its live count, caps, hit count and running counts
    const int64_t own = first_lane + t;
    const bool owner = t < kWarpLanes && own < p.lanes;
    const int live = owner ? __ldg(p.in_live + own) : 0;
    int end = live;  // the lane's slots are items end - live .. end - 1 of the warp's list
#pragma unroll
    for (int o = 1; o < kWarpLanes; o <<= 1) {
        const int v = __shfl_up_sync(kFull, end, o);
        if (t >= o) end += v;
    }
    int ends[kWarpLanes];
#pragma unroll
    for (int k = 0; k < kWarpLanes; ++k) ends[k] = __shfl_sync(kFull, end, k);
    const int items = ends[kWarpLanes - 1];
    if (items == 0) {
        if (owner) p.out_live[own] = 0;
        return;
    }
    int s_lim = p.s_cap, h_lim = p.h_cap;
    if (owner && p.caps != nullptr) {
        s_lim = __ldg(p.caps + own);
        h_lim = __ldg(p.caps + p.lanes + own);
    }
    const int32_t hit_base = owner ? p.hit_cnt[own] : 0;
    const int rounds = (items + 31) / 32;

    // the item of thread t in round r: lane j of the warp (kWarpLanes past the list), slot i - start
    auto locate = [&](int r, int& j, int& slot) {
        const int i = 32 * r + t;
        int start = 0;
        j = 0;
#pragma unroll
        for (int k = 0; k < kWarpLanes; ++k) {
            if (ends[k] <= i) {
                j = k + 1;
                start = ends[k];
            }
        }
        slot = i - start;
    };

    // count: hits in slot order, and the children of each kind
    Slot<SIGMA> st;
    int j = 0, slot = 0;
    int32_t found = 0;
    int32_t next[kKinds];
#pragma unroll
    for (int c = 0; c < kKinds; ++c) next[c] = 0;
    for (int r = 0; r < rounds; ++r) {
        locate(r, j, slot);
        load_slot<SIGMA, EDIT>(p, first_lane + j, slot, j < kWarpLanes, st);
        const unsigned run = __match_any_sync(kFull, j), own_run = owner ? run_of(end - live, end, r) : 0u;
        const unsigned fin = __ballot_sync(kFull, st.finished);
        const int32_t at = __shfl_sync(kFull, hit_base + found, j & 31);
        const int j_h_lim = __shfl_sync(kFull, h_lim, j & 31);
        if (st.finished) {
            const int h = at + __popc(fin & run & below);
            if (h < j_h_lim) {
                int32_t* hit = p.hits + (first_lane + j) * p.h_cap + h;
                const int64_t hplane = p.lanes * p.h_cap;
                hit[0] = st.lb;
                hit[hplane] = st.sz;
                hit[2 * hplane] = st.err;
            }
        }
        found += __popc(fin & own_run);
#pragma unroll
        for (int c = 0; c < kKinds; ++c) next[c] += __popc(__ballot_sync(kFull, (st.kinds >> c) & 1u) & own_run);
    }
    // each kind's first slot in its lane: the lane's children of the kinds before it
    int32_t total = 0;
#pragma unroll
    for (int c = 0; c < kKinds; ++c) {
        const int32_t n = next[c];
        next[c] = total;
        total += n;
    }
    if (owner) {
        p.out_live[own] = min(total, s_lim);
        if (found > 0) p.hit_cnt[own] = min(hit_base + found, h_lim);
        if (hit_base + found > h_lim) p.flags[p.lanes + own] = 1;
        if (total > s_lim) p.flags[own] = 1;
    }
    if (__ballot_sync(kFull, total > 0) == 0) return;

    // write: each child at its kind's next slot; a warp of one round still holds its slots in registers,
    // a longer one loads and ranks each round again
    for (int r = 0; r < rounds; ++r) {
        if (rounds > 1) {
            locate(r, j, slot);
            load_slot<SIGMA, EDIT>(p, first_lane + j, slot, j < kWarpLanes, st);
        }
        if (__ballot_sync(kFull, st.kinds != 0) == 0) continue;
        const unsigned run = __match_any_sync(kFull, j), own_run = owner ? run_of(end - live, end, r) : 0u;
        const int j_s_lim = __shfl_sync(kFull, s_lim, j & 31);
        emit_kind<SIGMA, 0, kKinds>(p, first_lane + j, j & 31, j_s_lim, st, run, below, own_run, next);
    }
}

template <int SIGMA>
int launch(bool edit, const Params& p, cudaStream_t stream) {
    constexpr int64_t kBlockLanes = static_cast<int64_t>(kWarps) * kWarpLanes;
    const unsigned blocks = static_cast<unsigned>((p.lanes + kBlockLanes - 1) / kBlockLanes);
    if (edit) {
        frontier_kernel<SIGMA, true><<<blocks, kThreads, 0, stream>>>(p);
    } else {
        frontier_kernel<SIGMA, false><<<blocks, kThreads, 0, stream>>>(p);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step of every lane: reads the frontier `state` and its live counts, writes the next frontier to
// `out` and its live counts to `out_live`, and updates the hit buffers, hit counts and overflow flags in
// place (shapes in Params; `caps` may be null).
extern "C" int sahara_frontier_step(const void* occ16, const void* c_arr, const void* qt, const void* tape,
                                    const void* state, const void* live, const void* caps, void* out,
                                    void* out_live, void* hits, void* hit_cnt, void* flags, int64_t lanes, int sigma,
                                    int edit, int m, int ns, int64_t rev_off, int s_cap, int h_cap, void* stream) {
    if (lanes <= 0) return 0;
    if (m < 1 || ns < 1 || s_cap < 1 || h_cap < 1 || rev_off < 0 || lanes / ns > (1ll << 31) ||
        lanes / (static_cast<int64_t>(kWarps) * kWarpLanes) >= 0x7FFFFFFFll) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p;
    p.occ16 = static_cast<const int32_t*>(occ16);
    p.c_arr = static_cast<const int32_t*>(c_arr);
    p.qt = static_cast<const int8_t*>(qt);
    p.tape = static_cast<const int32_t*>(tape);
    p.in = static_cast<const int32_t*>(state);
    p.in_live = static_cast<const int32_t*>(live);
    p.caps = static_cast<const int32_t*>(caps);
    p.out = static_cast<int32_t*>(out);
    p.out_live = static_cast<int32_t*>(out_live);
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
