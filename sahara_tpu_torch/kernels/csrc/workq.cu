// K5 workq_step: one step of the work-queue scheme search, in two launches.
//
// Replaces the state-queue step of sahara_tpu/engine/workq.py::workq_search
// (expand_step, :702-1073): the rank products and candidate flags of every
// queue row (:859-922), and the child rows built from the compacted
// candidates (:979-1055).  The TPU program stitched the compaction from
// f32 matrix products (_positions, _compact_matmul); here the caller runs
// one integer prefix sum (torch.cumsum) over the flags between the two
// kernels, and the second kernel scatters each flagged candidate to its
// slot.  Dedup and the hit drain run before the first kernel, in PyTorch.
//
//   workq_count  one thread per queue row: decode the packed meta word, read
//                the lane's tape word, rank-all at both interval ends on the
//                side's table (stacked occ16, word offset side * rev_off),
//                write cnt / newp / news for the sl live symbols to
//                prod[row, 3 * sl] and the candidate flags to
//                flags[branch, row] (branch-major: match/sub for symbols
//                1..sl-1, then for edit distance deletions 1..sl-1 and one
//                insertion), so the compacted children come out in the
//                reference's queue order.
//   workq_emit   one thread per candidate (branch, row); a flagged one writes
//                its child (lb, lbr, sz, meta) at slot pos[c] - 1 of the
//                inclusive scan.
//
// Bound on the H100: memory.  workq_count reads 16 B of state, a 4 B tape
// word and two 64 B occ rows per live row and writes 12 * sl + e_used bytes;
// the occ rows are scattered over an 80-160 MB table, so DRAM latency, not
// bandwidth, sets its pace, and one thread per row keeps enough of them in
// flight.  workq_emit reads a flag byte and a scan entry per candidate and
// about 36 B per child.
//
// Design: sigma and edit are template parameters (sigma <= 8); the meta bit
// layout (MetaLayout in engine/workq.py) is passed as field widths.

#include "occ.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kOpIns = 1, kOpDel = 2, kEdgeL = 4, kEdgeR = 8, kEdges = kEdgeL | kEdgeR;

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

struct Row {
    uint32_t opf, err, d, rest;
    int32_t word;
};

// Decode a meta word and fetch the lane's tape word (side | lo<<1 | hi<<5 |
// qc<<9 | maxlo<<17) at tape position min(d, m - 1).
__device__ __forceinline__ Row decode(uint32_t meta, const Layout& L, const int32_t* __restrict__ tape, int m,
                                      int ns) {
    Row r;
    r.opf = meta & L.opf_mask;
    r.err = (meta >> L.err_shift) & L.err_mask;
    r.d = (meta >> L.d_shift) & L.d_mask;
    const uint32_t s = (meta >> L.s_shift) & L.s_mask;
    const uint32_t q = (meta >> L.q_shift) & L.q_mask;
    r.rest = meta & ((L.s_mask << L.s_shift) | (L.q_mask << L.q_shift));
    const int64_t lane = static_cast<int64_t>(q) * ns + s;
    const int dc = r.d < static_cast<uint32_t>(m - 1) ? static_cast<int>(r.d) : m - 1;
    r.word = __ldg(tape + lane * m + dc);
    return r;
}

template <int SIGMA>
__device__ __forceinline__ void rank_at(const int32_t* __restrict__ table, int32_t pos, int32_t out[SIGMA]) {
    int32_t row[sahara::kRowInts];
    sahara::load_row(table, pos, row);
    const uint32_t mask = (1u << (pos & 31)) - 1u;
#pragma unroll
    for (int s = 0; s < SIGMA; ++s) out[s] = row[s] + __popc(static_cast<uint32_t>(row[SIGMA + s]) & mask);
}

template <int SIGMA, bool EDIT>
__global__ void __launch_bounds__(kThreads) count_kernel(
    const int32_t* __restrict__ occ16, const int32_t* __restrict__ c_arr, const int32_t* __restrict__ tape,
    const int32_t* __restrict__ lb, const int32_t* __restrict__ lbr, const int32_t* __restrict__ sz,
    const int32_t* __restrict__ meta, int64_t n, int sl, int m, int ns, int32_t rev_off, Layout L,
    int32_t* __restrict__ prod, uint8_t* __restrict__ flags) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const int n_ms = sl - 1;
    const int e_used = EDIT ? 2 * n_ms + 1 : n_ms;
    int32_t* p = prod + t * 3 * sl;
    const int32_t size = sz[t];
    if (size <= 0) {
        for (int b = 0; b < e_used; ++b) flags[b * n + t] = 0;
        for (int j = 0; j < 3 * sl; ++j) p[j] = 0;
        return;
    }
    const Row r = decode(static_cast<uint32_t>(meta[t]), L, tape, m, ns);
    const int side = r.word & 1;
    const uint32_t lo_b = (r.word >> 1) & 0xF, hi_b = (r.word >> 5) & 0xF;
    const int qc = (r.word >> 9) & 0xFF;
    const int32_t primary = side ? lbr[t] : lb[t];
    const int32_t secondary = side ? lb[t] : lbr[t];
    const int32_t* table = occ16 + static_cast<int64_t>(side ? rev_off : 0) * sahara::kRowInts;
    int32_t r_lo[SIGMA], r_hi[SIGMA];
    rank_at<SIGMA>(table, primary, r_lo);
    rank_at<SIGMA>(table, primary + size, r_hi);
    const uint32_t last = r.opf & 3u;
    int32_t prefix = 0;
#pragma unroll
    for (int j = 0; j < SIGMA; ++j) {
        if (j >= sl) break;
        const int32_t cnt = r_hi[j] - r_lo[j];
        p[j] = cnt;
        p[sl + j] = __ldg(c_arr + j) + r_lo[j];
        p[2 * sl + j] = secondary + prefix;
        prefix += cnt;
        if (j == 0) continue;
        const uint32_t e_ms = r.err + (qc != j ? 1u : 0u);
        flags[(j - 1) * n + t] = cnt > 0 && e_ms <= hi_b && e_ms >= lo_b;
        if (EDIT) flags[(n_ms + j - 1) * n + t] = cnt > 0 && r.err + 1 <= hi_b && r.d > 0 && last != kOpIns;
    }
    if (EDIT) flags[2 * n_ms * n + t] = r.err + 1 <= hi_b && r.err + 1 >= lo_b && last != kOpDel;
}

template <bool EDIT>
__global__ void __launch_bounds__(kThreads) emit_kernel(
    const uint8_t* __restrict__ flags, const int32_t* __restrict__ pos, const int32_t* __restrict__ prod,
    const int32_t* __restrict__ tape, const int32_t* __restrict__ lb, const int32_t* __restrict__ lbr,
    const int32_t* __restrict__ sz, const int32_t* __restrict__ meta, int64_t n, int sl, int m, int ns, Layout L,
    int32_t* __restrict__ out_lb, int32_t* __restrict__ out_lbr, int32_t* __restrict__ out_sz,
    int32_t* __restrict__ out_meta) {
    const int n_ms = sl - 1;
    const int64_t e_used = EDIT ? 2 * n_ms + 1 : n_ms;
    const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (c >= e_used * n || !flags[c]) return;
    const int64_t slot = pos[c] - 1;
    const int b = static_cast<int>(c / n);
    const int64_t parent = c - b * n;
    const Row r = decode(static_cast<uint32_t>(meta[parent]), L, tape, m, ns);
    const int side = r.word & 1;
    const int qc = (r.word >> 9) & 0xFF;
    int sym = b < n_ms ? b + 1 : b - n_ms + 1;
    sym = sym < 1 ? 1 : (sym > sl - 1 ? sl - 1 : sym);
    const int32_t* p = prod + parent * 3 * sl;
    const int32_t g_cnt = p[sym], g_newp = p[sl + sym], g_news = p[2 * sl + sym];
    const int32_t ext_lb = side ? g_news : g_newp;
    const int32_t ext_lbr = side ? g_newp : g_news;
    int32_t new_lb = ext_lb, new_lbr = ext_lbr, new_sz = g_cnt;
    uint32_t new_err = r.err + (qc != sym ? 1u : 0u), new_d = r.d + 1, new_op = 0;
    if (EDIT) {
        const bool is_del = b >= n_ms && b < 2 * n_ms;
        const bool is_ins = b >= 2 * n_ms;
        if (is_ins) {
            new_lb = lb[parent];
            new_lbr = lbr[parent];
            new_sz = sz[parent];
        }
        if (b >= n_ms) new_err = r.err + 1;
        if (is_del) new_d = r.d;
        const uint32_t edge_bit = side == 0 ? kEdgeL : kEdgeR;
        const uint32_t other_bit = side == 0 ? kEdgeR : kEdgeL;
        if (b < n_ms) {
            new_op = r.opf & other_bit;
        } else if (is_del) {
            new_op = kOpDel | (r.opf & kEdges) | edge_bit;
        } else {
            new_op = kOpIns | (r.opf & kEdges);
        }
    }
    out_lb[slot] = new_lb;
    out_lbr[slot] = new_lbr;
    out_sz[slot] = new_sz;
    out_meta[slot] = static_cast<int32_t>(new_op | (new_err << L.err_shift) | (new_d << L.d_shift) | r.rest);
}

template <int SIGMA>
int count_sigma(bool edit, const int32_t* occ16, const int32_t* c_arr, const int32_t* tape, const int32_t* lb,
                const int32_t* lbr, const int32_t* sz, const int32_t* meta, int64_t n, int sl, int m, int ns,
                int32_t rev_off, const Layout& L, int32_t* prod, uint8_t* flags, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    if (edit) {
        count_kernel<SIGMA, true><<<blocks, kThreads, 0, stream>>>(occ16, c_arr, tape, lb, lbr, sz, meta, n, sl,
                                                                     m, ns, rev_off, L, prod, flags);
    } else {
        count_kernel<SIGMA, false><<<blocks, kThreads, 0, stream>>>(occ16, c_arr, tape, lb, lbr, sz, meta, n, sl,
                                                                      m, ns, rev_off, L, prod, flags);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sahara_workq_count(const void* occ16, const void* c_arr, const void* tape, const void* lb,
                                  const void* lbr, const void* sz, const void* meta, int64_t n, int sigma, int sl,
                                  int edit, int m, int ns, int32_t rev_off, int opf_bits, int err_bits, int d_bits,
                                  int s_bits, void* prod, void* flags, void* stream) {
    if (n <= 0) return 0;
    if (sl < 2 || sl > sigma) return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = make_layout(opf_bits, err_bits, d_bits, s_bits);
    const auto* o = static_cast<const int32_t*>(occ16);
    const auto* c = static_cast<const int32_t*>(c_arr);
    const auto* tp = static_cast<const int32_t*>(tape);
    const auto* a = static_cast<const int32_t*>(lb);
    const auto* ar = static_cast<const int32_t*>(lbr);
    const auto* z = static_cast<const int32_t*>(sz);
    const auto* mt = static_cast<const int32_t*>(meta);
    auto* pr = static_cast<int32_t*>(prod);
    auto* fl = static_cast<uint8_t*>(flags);
    auto s = static_cast<cudaStream_t>(stream);
    const bool e = edit != 0;
    switch (sigma) {
        case 2: return count_sigma<2>(e, o, c, tp, a, ar, z, mt, n, sl, m, ns, rev_off, L, pr, fl, s);
        case 3: return count_sigma<3>(e, o, c, tp, a, ar, z, mt, n, sl, m, ns, rev_off, L, pr, fl, s);
        case 4: return count_sigma<4>(e, o, c, tp, a, ar, z, mt, n, sl, m, ns, rev_off, L, pr, fl, s);
        case 5: return count_sigma<5>(e, o, c, tp, a, ar, z, mt, n, sl, m, ns, rev_off, L, pr, fl, s);
        case 6: return count_sigma<6>(e, o, c, tp, a, ar, z, mt, n, sl, m, ns, rev_off, L, pr, fl, s);
        case 7: return count_sigma<7>(e, o, c, tp, a, ar, z, mt, n, sl, m, ns, rev_off, L, pr, fl, s);
        case 8: return count_sigma<8>(e, o, c, tp, a, ar, z, mt, n, sl, m, ns, rev_off, L, pr, fl, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" int sahara_workq_emit(const void* flags, const void* pos, const void* prod, const void* tape,
                                 const void* lb, const void* lbr, const void* sz, const void* meta, int64_t n,
                                 int sl, int edit, int m, int ns, int opf_bits, int err_bits, int d_bits, int s_bits,
                                 void* out_lb, void* out_lbr, void* out_sz, void* out_meta, void* stream) {
    if (n <= 0) return 0;
    if (sl < 2) return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = make_layout(opf_bits, err_bits, d_bits, s_bits);
    const int64_t e_used = edit ? 2 * (sl - 1) + 1 : sl - 1;
    const unsigned blocks = static_cast<unsigned>((e_used * n + kThreads - 1) / kThreads);
    auto s = static_cast<cudaStream_t>(stream);
    const auto* fl = static_cast<const uint8_t*>(flags);
    const auto* ps = static_cast<const int32_t*>(pos);
    const auto* pr = static_cast<const int32_t*>(prod);
    const auto* tp = static_cast<const int32_t*>(tape);
    const auto* a = static_cast<const int32_t*>(lb);
    const auto* ar = static_cast<const int32_t*>(lbr);
    const auto* z = static_cast<const int32_t*>(sz);
    const auto* mt = static_cast<const int32_t*>(meta);
    auto* ol = static_cast<int32_t*>(out_lb);
    auto* olr = static_cast<int32_t*>(out_lbr);
    auto* oz = static_cast<int32_t*>(out_sz);
    auto* om = static_cast<int32_t*>(out_meta);
    if (edit) {
        emit_kernel<true><<<blocks, kThreads, 0, s>>>(fl, ps, pr, tp, a, ar, z, mt, n, sl, m, ns, L, ol, olr, oz, om);
    } else {
        emit_kernel<false><<<blocks, kThreads, 0, s>>>(fl, ps, pr, tp, a, ar, z, mt, n, sl, m, ns, L, ol, olr, oz, om);
    }
    return static_cast<int>(cudaGetLastError());
}
