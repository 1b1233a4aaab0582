// K5 workq_step: one step of the work-queue scheme search in one launch.
//
// Replaces the state-queue step of sahara_tpu/engine/workq.py::make_step (:702-1073): the hit drain,
// the rank products and candidate flags of every queue row (:859-922), the compaction the TPU program
// stitched from f32 matrix products (_compact_matmul :204, _positions :259) and the child rows
// (:979-1055).  One thread per queue row, 256 rows a tile:
//
//   1. Row.  Decode the packed meta word and read the lane's tape word (side | lo<<1 | hi<<5 | qc<<9 |
//      maxlo<<17).  On drain steps (the DRAIN template flag) a row of a query whose pre-step hit count
//      has reached cap_per_query (when that is > 0) dies, and a row that consumed the query (d >= m)
//      leaves the queue, as a hit (lane, lb, sz, err) unless an edge flag says a shorter span exists.
//      A live row ranks at both interval ends on its side's table (stacked occ16, word offset
//      side * rev_off): every 16 B load of the two occ rows is in flight before any is used.  cnt / newp /
//      news and the candidate mask (one bit per branch) stay in registers.
//   2. Tile.  (children, hits) per row = (popcount of the mask, 0 or 1), packed in one word and scanned
//      with warp shuffles, then over the warp totals in shared memory.
//   3. Across tiles.  A single-pass decoupled look-back (Merrill & Garland 2016).  Tile ids come from
//      a ticket counter, not blockIdx, so every tile a block waits on already runs.  Each tile
//      publishes one 64-bit status word (epoch | flag | hits | children): first its aggregate, then its
//      inclusive prefix, with release stores read back with acquire loads.  The epoch tag retires the
//      previous step's words, so the status array is never cleared between steps.
//   4. Emit.  Each row builds its children in shared memory at its tile offset, structure-of-arrays
//      (lb, lbr, sz, meta), and the block writes them out coalesced from the tile's global base; the
//      hits likewise.  The last tile writes the (children, hits) totals for the host.
//
// Order is parent-major: parents in queue order, each parent's children in branch order (match/sub for
// symbols 1..sl-1, then for edit distance deletions 1..sl-1 and one insertion).  The reference's
// branch-major order would need every branch's grand total before the first child is placed.
//
// Bound on the H100: memory, and its latency more than its bandwidth.  Per row 16 B of state and a 4 B
// tape word; per live row two random 64 B occ rows of an 80-160 MB table; per child and per hit 16 B
// written.  Products, flags and the scan never reach global memory, and one thread per row, with both
// rows' loads started together, keeps many occ rows in flight.
//
// The dedup (sahara_workq_dedup, below) is a second entry of this file: it shares the step's meta layout
// and its static arguments.

#include "occ.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kOpIns = 1, kOpDel = 2, kEdgeL = 4, kEdgeR = 8, kEdges = kEdgeL | kEdgeR;

// Tile status word: children (bits 0-26) | hits (27-50) | flag (51-52) | epoch (53-63).  The host keeps
// a queue under 2^23 rows, so a step has under 15 * 2^23 < 2^27 children and under 2^24 hits, and packed
// values add without carrying from one field into the next.
constexpr int kHitShift = 27, kFlagShift = 51, kEpochShift = 53;
constexpr uint64_t kChildMask = (1ull << kHitShift) - 1;
constexpr uint64_t kValueMask = (1ull << kFlagShift) - 1;
constexpr uint64_t kAggregate = 1, kPrefix = 2;
constexpr int64_t kMaxRows = 1 << 23;
constexpr int kEpochs = 1 << (64 - kEpochShift);
// Shared memory a block may take without opting in, less room for the kernel's static part.
constexpr size_t kDefaultSmem = 47 * 1024;

struct Layout {
    uint32_t err_shift, d_shift, s_shift, q_shift;
    uint32_t opf_mask, err_mask, d_mask, s_mask, q_mask;
};

Layout make_layout(int opf_bits, int err_bits, int d_bits, int s_bits) {
    Layout L;
    L.err_shift = opf_bits;
    L.d_shift = L.err_shift + err_bits;
    L.s_shift = L.d_shift + d_bits;
    L.q_shift = L.s_shift + s_bits;
    L.opf_mask = (1u << opf_bits) - 1u;
    L.err_mask = (1u << err_bits) - 1u;
    L.d_mask = (1u << d_bits) - 1u;
    L.s_mask = (1u << s_bits) - 1u;
    L.q_mask = L.q_shift >= 32 ? 0u : (0xFFFFFFFFu >> L.q_shift);
    return L;
}

}  // namespace

// What every step of one search reads, filled once per search by the host (kernels/workq.py::_Static,
// field for field; every field 8 bytes, so the two layouts cannot drift apart by padding).
struct StepStatic {
    const int32_t* occ16;
    const int32_t* c_arr;
    const int32_t* tape;
    const int32_t* hq_counts;  // int32[nq] when cap_per_query > 0
    unsigned long long* status;  // one word per tile, zero when allocated
    int32_t* counters;  // children total, hits total, ticket
    int64_t sigma, sl, edit, m, ns, rev_off, opf_bits, err_bits, d_bits, s_bits, cap_per_query, max_tiles;
};

namespace {

struct Params {
    const int32_t* occ16;
    const int32_t* c_arr;
    const int32_t* tape;
    const int32_t* hq_counts;
    const int32_t* lb;
    const int32_t* lbr;
    const int32_t* sz;
    const int32_t* meta;
    unsigned long long* status;
    int32_t* counters;
    int32_t* out;  // children int32[4, child_cap]: lb | lbr | sz | meta
    int32_t* hits;  // int32[4, n]: lane | lb | sz | err (drain steps)
    int64_t child_cap;
    int n, sl, m, ns, cap_per_query;
    int32_t rev_off;
    uint32_t ticket_base, epoch;
    Layout L;
};

__device__ __forceinline__ uint64_t load_status(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

// A release store: the fence before it orders everything this thread wrote earlier.
__device__ __forceinline__ void store_status(unsigned long long* p, uint64_t flag, uint32_t epoch, uint64_t value) {
    const unsigned long long v = (static_cast<uint64_t>(epoch) << kEpochShift) | (flag << kFlagShift) | value;
    asm volatile("st.release.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Exclusive prefix of `tile` (> 0), run by one whole warp.  Each round reads the 32 status words before
// the window's end, waits until each carries this epoch's flag, and sums back to the nearest inclusive
// prefix; a window of aggregates alone adds up and moves the window 32 tiles back.
__device__ uint64_t look_back(const unsigned long long* status, int64_t tile, uint32_t epoch) {
    const int lane = threadIdx.x & 31;
    uint64_t excl = 0;
    for (int64_t end = tile - 1;; end -= 32) {
        const int64_t idx = end - lane;
        uint64_t s = kPrefix << kFlagShift;  // before tile 0: an inclusive prefix of 0
        if (idx >= 0) {
            do {
                s = load_status(status + idx);
            } while ((s >> kEpochShift) != epoch || ((s >> kFlagShift) & 3) == 0);
        }
        const unsigned prefixes = __ballot_sync(kFull, ((s >> kFlagShift) & 3) == kPrefix);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        uint64_t v = lane <= stop ? (s & kValueMask) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        excl += v;
        if (prefixes) return excl;
    }
}

template <int SIGMA, bool EDIT, bool DRAIN>
__global__ void __launch_bounds__(kThreads) step_kernel(const Params p) {
    // children staging: lb | lbr | sz | meta, kThreads * e_used each; then on drain steps the hits
    // staging: lane | lb | sz | err, kThreads each
    extern __shared__ int32_t stage[];
    __shared__ uint32_t s_warp[kWarps];
    __shared__ uint32_t s_tile;
    __shared__ uint64_t s_base;

    const Layout& L = p.L;
    const int n_ms = p.sl - 1;
    const int e_used = EDIT ? 2 * n_ms + 1 : n_ms;
    const int stride = kThreads * e_used;
    int32_t* const hstage = stage + 4 * stride;

    if (threadIdx.x == 0) s_tile = atomicAdd(reinterpret_cast<unsigned*>(p.counters + 2), 1u) - p.ticket_base;
    __syncthreads();
    const int64_t tile = s_tile;
    const int64_t t = tile * kThreads + threadIdx.x;

    // 1. this row
    int32_t lb = 0, lbr = 0, size = 0;
    if (t < p.n) {
        lb = p.lb[t];
        lbr = p.lbr[t];
        size = p.sz[t];
    }
    bool alive = size > 0, hit = false;
    uint32_t opf = 0, err = 0, d = 0, rest = 0, lane = 0;
    int32_t word = 0;
    if (alive) {
        const uint32_t meta = static_cast<uint32_t>(p.meta[t]);
        opf = meta & L.opf_mask;
        err = (meta >> L.err_shift) & L.err_mask;
        d = (meta >> L.d_shift) & L.d_mask;
        const uint32_t s = (meta >> L.s_shift) & L.s_mask;
        const uint32_t q = (meta >> L.q_shift) & L.q_mask;
        rest = meta & ((L.s_mask << L.s_shift) | (L.q_mask << L.q_shift));
        lane = q * p.ns + s;
        const int dc = d < static_cast<uint32_t>(p.m - 1) ? static_cast<int>(d) : p.m - 1;
        word = __ldg(p.tape + static_cast<int64_t>(lane) * p.m + dc);
        if (DRAIN) {
            if (p.cap_per_query > 0 && __ldg(p.hq_counts + q) >= p.cap_per_query) {
                alive = false;
            } else if (d >= static_cast<uint32_t>(p.m)) {
                hit = (opf & kEdges) == 0;
                alive = false;
            }
        }
    }
    const int side = word & 1;
    const uint32_t lo_b = (word >> 1) & 0xF, hi_b = (word >> 5) & 0xF;
    const int qc = (word >> 9) & 0xFF;
    const uint32_t last = opf & 3u;
    int32_t cnt[SIGMA] = {}, newp[SIGMA] = {}, news[SIGMA] = {};
    uint32_t mask = 0;
    if (alive) {
        const int32_t primary = side ? lbr : lb;
        const int32_t secondary = side ? lb : lbr;
        int32_t r_lo[SIGMA], r_hi[SIGMA];
        sahara::rank_pair<SIGMA>(p.occ16 + static_cast<int64_t>(side ? p.rev_off : 0) * sahara::kRowInts, primary,
                         primary + size, r_lo, r_hi);
        int32_t prefix = 0;
#pragma unroll
        for (int j = 0; j < SIGMA; ++j) {
            cnt[j] = r_hi[j] - r_lo[j];
            newp[j] = __ldg(p.c_arr + j) + r_lo[j];
            news[j] = secondary + prefix;
            prefix += cnt[j];
        }
#pragma unroll
        for (int j = 1; j < SIGMA; ++j) {
            if (j >= p.sl) break;
            const uint32_t e_ms = err + (qc != j ? 1u : 0u);
            if (cnt[j] > 0 && e_ms <= hi_b && e_ms >= lo_b) mask |= 1u << (j - 1);
            if (EDIT && cnt[j] > 0 && err + 1 <= hi_b && d > 0 && last != kOpIns) mask |= 1u << (n_ms + j - 1);
        }
        if (EDIT && err + 1 <= hi_b && err + 1 >= lo_b && last != kOpDel) mask |= 1u << (2 * n_ms);
    }

    // 2. block scan of (children | hits << 16)
    const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t own = __popc(mask) | (static_cast<uint32_t>(hit) << 16);
    uint32_t incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, incl, o);
        if (wl >= o) incl += y;
    }
    if (wl == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        uint32_t w = wl < kWarps ? s_warp[wl] : 0;
#pragma unroll
        for (int o = 1; o < kWarps; o <<= 1) {
            const uint32_t y = __shfl_up_sync(kFull, w, o);
            if (wl >= o) w += y;
        }
        if (wl < kWarps) s_warp[wl] = w;
    }
    __syncthreads();
    const uint32_t excl = (warp ? s_warp[warp - 1] : 0) + incl - own;
    const uint32_t tile_total = s_warp[kWarps - 1];

    // 4a. stage this row's children and hit at the tile offsets
    if (mask) {
        int k = excl & 0xFFFF;
        const uint32_t edge_bit = side == 0 ? kEdgeL : kEdgeR;
        const uint32_t other_bit = side == 0 ? kEdgeR : kEdgeL;
        auto put = [&](int32_t c_lb, int32_t c_lbr, int32_t c_sz, uint32_t op, uint32_t c_err, uint32_t c_d) {
            stage[k] = c_lb;
            stage[stride + k] = c_lbr;
            stage[2 * stride + k] = c_sz;
            stage[3 * stride + k] = static_cast<int32_t>(op | (c_err << L.err_shift) | (c_d << L.d_shift) | rest);
            ++k;
        };
#pragma unroll
        for (int j = 1; j < SIGMA; ++j) {
            if (j >= p.sl) break;
            if (mask >> (j - 1) & 1u) {
                put(side ? news[j] : newp[j], side ? newp[j] : news[j], cnt[j], EDIT ? opf & other_bit : 0u,
                    err + (qc != j ? 1u : 0u), d + 1);
            }
        }
        if (EDIT) {
#pragma unroll
            for (int j = 1; j < SIGMA; ++j) {
                if (j >= p.sl) break;
                if (mask >> (n_ms + j - 1) & 1u) {
                    put(side ? news[j] : newp[j], side ? newp[j] : news[j], cnt[j],
                        kOpDel | (opf & kEdges) | edge_bit, err + 1, d);
                }
            }
            if (mask >> (2 * n_ms) & 1u) put(lb, lbr, size, kOpIns | (opf & kEdges), err + 1, d + 1);
        }
    }
    if (DRAIN && hit) {
        const int h = excl >> 16;
        hstage[h] = static_cast<int32_t>(lane);
        hstage[kThreads + h] = lb;
        hstage[2 * kThreads + h] = size;
        hstage[3 * kThreads + h] = static_cast<int32_t>(err);
    }

    // 3. the tile's global base
    if (warp == 0) {
        const uint64_t agg = (tile_total & 0xFFFF) | (static_cast<uint64_t>(tile_total >> 16) << kHitShift);
        uint64_t base = 0;
        if (tile == 0) {
            if (wl == 0) store_status(p.status, kPrefix, p.epoch, agg);
        } else {
            if (wl == 0) store_status(p.status + tile, kAggregate, p.epoch, agg);
            base = look_back(p.status, tile, p.epoch);
            if (wl == 0) store_status(p.status + tile, kPrefix, p.epoch, base + agg);
        }
        if (wl == 0) s_base = base;
    }
    __syncthreads();

    // 4b. write the staged rows out
    const int64_t base_c = static_cast<int64_t>(s_base & kChildMask);
    const int64_t base_h = static_cast<int64_t>(s_base >> kHitShift);
    const int n_c = tile_total & 0xFFFF, n_h = tile_total >> 16;
    for (int i = threadIdx.x; i < n_c; i += kThreads) {
#pragma unroll
        for (int f = 0; f < 4; ++f) p.out[f * p.child_cap + base_c + i] = stage[f * stride + i];
    }
    if (DRAIN) {
        for (int i = threadIdx.x; i < n_h; i += kThreads) {
#pragma unroll
            for (int f = 0; f < 4; ++f) p.hits[static_cast<int64_t>(f) * p.n + base_h + i] = hstage[f * kThreads + i];
        }
    }
    if (threadIdx.x == 0 && tile == (p.n - 1) / kThreads) {
        p.counters[0] = static_cast<int32_t>(base_c + n_c);
        p.counters[1] = static_cast<int32_t>(base_h + n_h);
    }
}

template <int SIGMA, bool EDIT, bool DRAIN>
int launch(const Params& p, unsigned blocks, cudaStream_t stream) {
    const int e_used = EDIT ? 2 * (p.sl - 1) + 1 : p.sl - 1;
    const size_t smem = sizeof(int32_t) * (4 * kThreads * e_used + (DRAIN ? 4 * kThreads : 0));
    if (smem > kDefaultSmem) {
        const cudaError_t e = cudaFuncSetAttribute(step_kernel<SIGMA, EDIT, DRAIN>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    step_kernel<SIGMA, EDIT, DRAIN><<<blocks, kThreads, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int SIGMA>
int launch_sigma(bool edit, bool drain, const Params& p, unsigned blocks, cudaStream_t stream) {
    if (edit) {
        return drain ? launch<SIGMA, true, true>(p, blocks, stream) : launch<SIGMA, true, false>(p, blocks, stream);
    }
    return drain ? launch<SIGMA, false, true>(p, blocks, stream) : launch<SIGMA, false, false>(p, blocks, stream);
}

}  // namespace

// One step over the n-row queue (lb, lbr, sz, meta).  children is int32[4, child_cap] with child_cap >=
// e_used * n, hits int32[4, n] on drain steps (else unused); the kernel writes the (children, hits)
// totals to counters[0:2].  ticket_base is the ticket counter's value before this launch and epoch this
// step's tag (1 .. 2^11 - 1, never repeated while the status array holds words of an earlier step).
extern "C" int sahara_workq_step(const StepStatic* st, const void* lb, const void* lbr, const void* sz,
                                 const void* meta, int64_t n, int drain, uint32_t ticket_base, uint32_t epoch,
                                 void* children, int64_t child_cap, void* hits, void* stream) {
    if (n <= 0) return 0;
    const int64_t tiles = (n + kThreads - 1) / kThreads;
    const int64_t e_used = st->edit ? 2 * (st->sl - 1) + 1 : st->sl - 1;
    if (st->sl < 2 || st->sl > st->sigma || n > kMaxRows || tiles > st->max_tiles || child_cap < e_used * n ||
        epoch == 0 || epoch >= static_cast<uint32_t>(kEpochs) || (drain && hits == nullptr) ||
        (drain && st->cap_per_query > 0 && st->hq_counts == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p;
    p.occ16 = st->occ16;
    p.c_arr = st->c_arr;
    p.tape = st->tape;
    p.hq_counts = st->hq_counts;
    p.lb = static_cast<const int32_t*>(lb);
    p.lbr = static_cast<const int32_t*>(lbr);
    p.sz = static_cast<const int32_t*>(sz);
    p.meta = static_cast<const int32_t*>(meta);
    p.status = st->status;
    p.counters = st->counters;
    p.out = static_cast<int32_t*>(children);
    p.hits = static_cast<int32_t*>(hits);
    p.child_cap = child_cap;
    p.n = static_cast<int>(n);
    p.sl = static_cast<int>(st->sl);
    p.m = static_cast<int>(st->m);
    p.ns = static_cast<int>(st->ns);
    p.cap_per_query = static_cast<int>(st->cap_per_query);
    p.rev_off = static_cast<int32_t>(st->rev_off);
    p.ticket_base = ticket_base;
    p.epoch = epoch;
    p.L = make_layout(static_cast<int>(st->opf_bits), static_cast<int>(st->err_bits), static_cast<int>(st->d_bits),
                      static_cast<int>(st->s_bits));
    const unsigned blocks = static_cast<unsigned>(tiles);
    const bool e = st->edit != 0, dr = drain != 0;
    auto s = static_cast<cudaStream_t>(stream);
    switch (st->sigma) {
        case 2: return launch_sigma<2>(e, dr, p, blocks, s);
        case 3: return launch_sigma<3>(e, dr, p, blocks, s);
        case 4: return launch_sigma<4>(e, dr, p, blocks, s);
        case 5: return launch_sigma<5>(e, dr, p, blocks, s);
        case 6: return launch_sigma<6>(e, dr, p, blocks, s);
        case 7: return launch_sigma<7>(e, dr, p, blocks, s);
        case 8: return launch_sigma<8>(e, dr, p, blocks, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The work-queue dedup: replaces the dedup of sahara_tpu/engine/workq.py::make_step (_dedup_sz :771, run
// every dedup_every-th step); kernels/dedup.py::workq_dedup_plain is the same function in PyTorch.  Two
// launches on the stream, no read-back, no memset:
//
//   1. Elect, a thread per row.  A live row (sz > 0) hashes its cursor (lb, lbr, sz and the meta word's
//      d | s | q bits) to one of ht = 2^cb slots, cb = bit_length(n - 1), and takes there the atomicMax of
//      epoch << 32 | ~pri, pri = err << (cb + 2) | min(bad, 3) << cb | row, bad counting its op and edge
//      flags.  Within a call the maximum is the least priority; an entry of an earlier call (a smaller
//      epoch) loses to any of this call's, so the table, which stays with the search, is never cleared.
//      The extremum does not depend on the order of the atomics: the slots hold the plain version's
//      scatter-min.
//   2. Kill, a thread per row.  A live row whose slot's winner (the priority's row bits) is another row
//      with the same cursor that can reproduce every future transition of it (equal err, or lower err
//      once no later lower bound exceeds it; a subset of its edge flags; a compatible last op) writes 0,
//      every other row its sz.  Only such a row reads its tape word, for the largest later lower bound.
//      A block adds its kills to counters[3], which the step's count read-back returns.
//
// The hash is the plain version's int64 hash cut to 32 bits: the low bits of a product depend only on the
// low bits of its factors, and the slot is the low cb <= 23 bits.  A priority stays under 2^28 (err <= 7,
// cb <= 23), so it fits the entry's low word.  A Hamming layout has no op or edge bits (opf_bits = 0): bad
// is 0 and the flag tests pass, the same code.
//
// Bound on the H100: the launches.  Per row 16 B of state read twice and 4 B written, an 8 B atomic and an
// 8 B table read; per killed candidate the winner's 16 B and a tape word.  A dedup of ~54 K rows is ~2.5 MB,
// under a microsecond of bandwidth: the two launches' fixed costs set its time.
namespace {

constexpr int kDedupThreads = 256;
constexpr uint32_t kHash0 = 0x9E3779B1u, kHash1 = 0x85EBCA77u, kHash2 = 0xC2B2AE3Du, kHash3 = 0x27D4EB2Fu;

struct DedupParams {
    const int32_t* tape;
    const int32_t* lb;
    const int32_t* lbr;
    const int32_t* sz;
    const int32_t* meta;
    int32_t* out;
    unsigned long long* table;  // epoch << 32 | ~priority
    int32_t* counters;
    int n, m, ns, cb;
    uint32_t epoch;
    uint32_t key_mask;  // d | s | q: the cursor's bits of the meta word
    Layout L;
};

__device__ __forceinline__ uint32_t dedup_slot(const DedupParams& p, int32_t lb, int32_t lbr, int32_t size,
                                               uint32_t meta) {
    const uint32_t h = (static_cast<uint32_t>(lb) * kHash0) ^ (static_cast<uint32_t>(lbr) * kHash1) ^
                       (static_cast<uint32_t>(size) * kHash2) ^ ((meta & p.key_mask) * kHash3);
    return h & ((1u << p.cb) - 1u);
}

__global__ void __launch_bounds__(kDedupThreads) dedup_elect(const DedupParams p) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kDedupThreads + threadIdx.x;
    if (t >= p.n) return;
    const int32_t size = p.sz[t];
    if (size <= 0) return;
    const uint32_t meta = static_cast<uint32_t>(p.meta[t]);
    const uint32_t opf = meta & p.L.opf_mask;
    const uint32_t err = (meta >> p.L.err_shift) & p.L.err_mask;
    const uint32_t bad = ((opf & 3u) != 0 ? 1u : 0u) + ((opf >> 2) & 1u) + ((opf >> 3) & 1u);
    const uint32_t pri = (err << (p.cb + 2)) | ((bad < 3u ? bad : 3u) << p.cb) | static_cast<uint32_t>(t);
    atomicMax(p.table + dedup_slot(p, p.lb[t], p.lbr[t], size, meta),
              (static_cast<unsigned long long>(p.epoch) << 32) | ~pri);
}

__global__ void __launch_bounds__(kDedupThreads) dedup_kill(const DedupParams p) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kDedupThreads + threadIdx.x;
    const int32_t size = t < p.n ? p.sz[t] : 0;
    bool kill = false;
    if (size > 0) {
        const int32_t lb = p.lb[t], lbr = p.lbr[t];
        const uint32_t meta = static_cast<uint32_t>(p.meta[t]);
        // this row's own entry has this epoch, so the slot's does too
        const uint32_t won = ~static_cast<uint32_t>(p.table[dedup_slot(p, lb, lbr, size, meta)]) & ((1u << p.cb) - 1u);
        const int64_t win = won < static_cast<uint32_t>(p.n) ? static_cast<int64_t>(won) : p.n - 1;
        if (win != t) {
            const uint32_t w_meta = static_cast<uint32_t>(p.meta[win]);
            if (p.lb[win] == lb && p.lbr[win] == lbr && p.sz[win] == size && ((w_meta ^ meta) & p.key_mask) == 0) {
                const Layout& L = p.L;
                const uint32_t opf = meta & L.opf_mask, w_opf = w_meta & L.opf_mask;
                const uint32_t err = (meta >> L.err_shift) & L.err_mask, w_err = (w_meta >> L.err_shift) & L.err_mask;
                const uint32_t d = (meta >> L.d_shift) & L.d_mask;
                const uint32_t lane = ((meta >> L.q_shift) & L.q_mask) * p.ns + ((meta >> L.s_shift) & L.s_mask);
                const int dc = d < static_cast<uint32_t>(p.m - 1) ? static_cast<int>(d) : p.m - 1;
                const uint32_t maxlo = (__ldg(p.tape + static_cast<int64_t>(lane) * p.m + dc) >> 17) & 0xFu;
                const bool err_dom = w_err == err || (w_err < err && maxlo <= w_err);
                const bool edge_dom = (w_opf & kEdges & ~opf) == 0;
                const bool op_dom = (w_opf & 3u) == 0 || (w_opf & 3u) == (opf & 3u);
                kill = err_dom && edge_dom && op_dom;
            }
        }
    }
    if (t < p.n) p.out[t] = kill ? 0 : size;
    const int kills = __syncthreads_count(kill);
    if (threadIdx.x == 0 && kills > 0) atomicAdd(p.counters + 3, kills);
}

}  // namespace

// sz of the n-row queue (lb, lbr, sz, meta) with dominated rows set to 0, into out (int32[n], not sz).  table
// holds table_words >= 2^bit_length(n - 1) 64-bit entries, zero when allocated, whose epochs are all below
// epoch (1 .. 2^32 - 1: one more than the previous call's on this table).  Adds the rows it zeroed to
// counters[3].
extern "C" int sahara_workq_dedup(const StepStatic* st, const void* lb, const void* lbr, const void* sz,
                                  const void* meta, int64_t n, void* out, void* table, int64_t table_words,
                                  uint32_t epoch, void* stream) {
    if (n <= 0) return 0;
    int cb = 0;
    while ((int64_t{1} << cb) < n) ++cb;  // bit_length(n - 1)
    if (n > kMaxRows || table_words < (int64_t{1} << cb) || epoch == 0 || st->m < 1 || st->ns < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    DedupParams p;
    p.tape = st->tape;
    p.lb = static_cast<const int32_t*>(lb);
    p.lbr = static_cast<const int32_t*>(lbr);
    p.sz = static_cast<const int32_t*>(sz);
    p.meta = static_cast<const int32_t*>(meta);
    p.out = static_cast<int32_t*>(out);
    p.table = static_cast<unsigned long long*>(table);
    p.counters = st->counters;
    p.n = static_cast<int>(n);
    p.m = static_cast<int>(st->m);
    p.ns = static_cast<int>(st->ns);
    p.cb = cb;
    p.epoch = epoch;
    p.L = make_layout(static_cast<int>(st->opf_bits), static_cast<int>(st->err_bits), static_cast<int>(st->d_bits),
                      static_cast<int>(st->s_bits));
    p.key_mask = ~((1u << p.L.d_shift) - 1u);
    auto s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>((n + kDedupThreads - 1) / kDedupThreads);
    dedup_elect<<<blocks, kDedupThreads, 0, s>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    dedup_kill<<<blocks, kDedupThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
}
