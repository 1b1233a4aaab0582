// K4 rank_all_smem: all-sigma ranks with the whole occ16 table in shared memory.
//
// Replaces sahara_tpu/kernels/rank.py::rank_all_vmem (Pallas, table resident
// in VMEM) and computes K1's function: out[t, s] = occ[i >> 5, s]
// + popcount(occ[i >> 5, sigma + s] & ((1 << (i & 31)) - 1)) for i = idx[t].
//
// Bound on the H100: memory.  The indices and the output move through DRAM
// once, n * (4 + 4 * sigma) bytes, and the table once.  Row reads then come
// from shared memory instead of DRAM, so the scattered-row latency of K1
// goes away; what is left is staging the table into every SM.
//
// Design, for this card:
//   - one CTA of 1024 threads per SM, in clusters of kClusterCtas CTAs, as
//     many clusters as can be resident at once (grid-stride over warps);
//   - staging: each CTA arms one mbarrier for the table's bytes, the
//     cluster syncs, and CTA c issues one TMA bulk copy of slice c of the
//     table, multicast into the same offset of every CTA of the cluster.
//     The L2 serves each table once per cluster, not once per SM, and no
//     thread spends an instruction on the copy: each loads its first index
//     meanwhile, then waits on the barrier;
//   - conflict-free row reads: a 64 B row is four 16 B vectors, and vector
//     v of row r lies in bank group (4 r + v) % 8, so eight threads reading
//     vector v of random rows met only two groups.  Each thread reads its
//     row's vectors in the order (v + (r >> 1)) % 4, which spreads every
//     load over all eight groups, and undoes the rotation in registers;
//   - the output leaves coalesced: a warp writes its 32 x sigma block as
//     sigma whole 128 B lines after an in-register transpose (rank_io.cuh),
//     with an evict-first L2 policy (written once);
//   - the launch shape (table budget, resident clusters) is read once per
//     process and sigma; the shared-memory attribute is raised then too.
// The table must fit one CTA's opt-in shared memory beside the mbarrier
// (232,384 B on the H100: 3,631 rows, ~116k text positions); the wrapper
// refuses larger ones, and a card that cannot hold a cluster of such CTAs
// makes the launch fail.

#include "occ.cuh"
#include "rank_io.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kClusterCtas = 2;  // N, kept by measurement on the H100 (PERF.md)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

// Wait for phase 0 of the mbarrier at shared address bar to complete.
__device__ __forceinline__ void wait_parity0(uint32_t bar) {
    for (uint32_t done = 0, spin = 0; !done; ++spin) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar), "r"(0)
            : "memory");
        if (spin == (1u << 26)) __trap();  // the table never arrived: fail the launch rather than hang
    }
}

template <int SIGMA>
__global__ void __launch_bounds__(kThreads, 1) rank_smem_kernel(const int4* __restrict__ occ16, int32_t w_rows,
                                                                const int32_t* __restrict__ idx, int64_t n,
                                                                int32_t* __restrict__ out) {
    extern __shared__ __align__(16) int4 table[];
    __shared__ __align__(8) uint64_t full;
    const int lane = threadIdx.x & 31;
    const uint32_t bar = smem_u32(&full);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every CTA's barrier is armed before any copy of the cluster signals it
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (threadIdx.x == 0) {  // arm for the whole table, then copy slice c of it from CTA c
        const int32_t n_vec = w_rows * (sahara::kRowInts / 4);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(n_vec * 16) : "memory");
        const int32_t per = (n_vec + kClusterCtas - 1) / kClusterCtas;
        const int32_t lo = static_cast<int32_t>(cluster_rank()) * per;
        const int32_t cnt = min(per, n_vec - lo);
        if (cnt > 0) {
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
                " [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(table + lo)),
                "l"(occ16 + lo), "r"(cnt * 16), "r"(bar), "h"(static_cast<uint16_t>((1 << kClusterCtas) - 1))
                : "memory");
        }
    }
    const uint64_t first = sahara::policy_evict_first();
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    int64_t base = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) & ~int64_t{31};
    int32_t pos = base + lane < n ? sahara::load_int(idx + base + lane, first) : 0;
    wait_parity0(bar);
    // this CTA's copy of the table is whole: no peer writes into it any more
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    const sahara::WarpTranspose<SIGMA> tp(lane);
    for (; base < n; base += stride) {  // warp-uniform
        const int64_t next = base + stride;
        const int32_t pos_next = next + lane < n ? sahara::load_int(idx + next + lane, first) : 0;
        const int rot = (pos >> 6) & 3;  // (row >> 1) % 4
        const int4* row = table + (pos >> 5) * (sahara::kRowInts / 4);
        int4 x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = row[(j + rot) & 3];  // x[j] is vector (j + rot) % 4
        if (rot & 2) {
            const int4 a = x[0], b = x[1];
            x[0] = x[2];
            x[1] = x[3];
            x[2] = a;
            x[3] = b;
        }
        if (rot & 1) {
            const int4 a = x[3];
            x[3] = x[2];
            x[2] = x[1];
            x[1] = x[0];
            x[0] = a;
        }
        int32_t r[sahara::kRowInts];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            r[4 * v + 0] = x[v].x;
            r[4 * v + 1] = x[v].y;
            r[4 * v + 2] = x[v].z;
            r[4 * v + 3] = x[v].w;
        }
        const uint32_t mask = (1u << (pos & 31)) - 1u;
        int32_t res[SIGMA];
#pragma unroll
        for (int s = 0; s < SIGMA; ++s) res[s] = r[s] + __popc(static_cast<uint32_t>(r[SIGMA + s]) & mask);
        const int rows = n - base < 32 ? static_cast<int>(n - base) : 32;
        tp.store(res, out + base * SIGMA, rows * SIGMA, first);
        pos = pos_next;
    }
    // no CTA exits while a peer of its cluster may still signal it
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Launch shape of one sigma, read once per process.
struct Shape {
    cudaError_t err;
    int budget;    // bytes of table a CTA can hold beside the barrier
    int clusters;  // clusters resident at once
};

template <int SIGMA>
const Shape& shape() {
    static const Shape s = [] {
        Shape r{cudaSuccess, 0, 0};
        int dev = 0, optin = 0;
        cudaFuncAttributes attr{};
        r.err = cudaGetDevice(&dev);
        if (r.err == cudaSuccess) r.err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (r.err == cudaSuccess) r.err = cudaFuncGetAttributes(&attr, rank_smem_kernel<SIGMA>);
        if (r.err != cudaSuccess) return r;
        const int row = sahara::kRowInts * 4;
        r.budget = (optin - static_cast<int>(attr.sharedSizeBytes) - 16) / row * row;  // 16: the table's alignment
        r.err = cudaFuncSetAttribute(rank_smem_kernel<SIGMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, r.budget);
        if (r.err != cudaSuccess) return r;
        cudaLaunchConfig_t cfg{};
        cudaLaunchAttribute cluster[1];
        cluster[0].id = cudaLaunchAttributeClusterDimension;
        cluster[0].val.clusterDim.x = kClusterCtas;
        cluster[0].val.clusterDim.y = 1;
        cluster[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(kClusterCtas);
        cfg.blockDim = dim3(kThreads);
        cfg.dynamicSmemBytes = static_cast<size_t>(r.budget);
        cfg.attrs = cluster;
        cfg.numAttrs = 1;
        r.err = cudaOccupancyMaxActiveClusters(&r.clusters, rank_smem_kernel<SIGMA>, &cfg);
        if (r.err == cudaSuccess && r.clusters < 1) r.err = cudaErrorInvalidConfiguration;
        return r;
    }();
    return s;
}

template <int SIGMA>
int grid_ctas(int64_t n, int* ctas) {
    const Shape& s = shape<SIGMA>();
    if (s.err != cudaSuccess) return static_cast<int>(s.err);
    const int64_t clusters = ((n + kThreads - 1) / kThreads + kClusterCtas - 1) / kClusterCtas;
    *ctas = static_cast<int>(clusters < s.clusters ? clusters : s.clusters) * kClusterCtas;
    return 0;
}

template <int SIGMA>
int launch(const int4* occ16, int32_t w_rows, const int32_t* idx, int64_t n, int32_t* out, cudaStream_t stream) {
    int ctas = 0;
    const int err = grid_ctas<SIGMA>(n, &ctas);
    if (err != 0) return err;
    const int64_t smem = static_cast<int64_t>(w_rows) * sahara::kRowInts * 4;
    if (w_rows < 1 || smem > shape<SIGMA>().budget) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg{};
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = kClusterCtas;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, rank_smem_kernel<SIGMA>, occ16, w_rows, idx, n, out);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" int sahara_rank_all_smem(const void* occ16, int32_t w_rows, const void* idx, int64_t n, int sigma,
                                    void* out, void* stream) {
    if (n <= 0) return 0;
    const auto* o = static_cast<const int4*>(occ16);
    const auto* x = static_cast<const int32_t*>(idx);
    auto* y = static_cast<int32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (sigma) {
        case 2: return launch<2>(o, w_rows, x, n, y, s);
        case 3: return launch<3>(o, w_rows, x, n, y, s);
        case 4: return launch<4>(o, w_rows, x, n, y, s);
        case 5: return launch<5>(o, w_rows, x, n, y, s);
        case 6: return launch<6>(o, w_rows, x, n, y, s);
        case 7: return launch<7>(o, w_rows, x, n, y, s);
        case 8: return launch<8>(o, w_rows, x, n, y, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Launch shape for n positions: shape[0] the grid's CTAs, shape[1] the CTAs
// of a cluster, shape[2] the table bytes a CTA can hold.
extern "C" int sahara_rank_all_smem_shape(int64_t n, int sigma, int32_t* shape_out) {
    int ctas = 0, err = 0, budget = 0;
    switch (sigma) {
        case 2: err = grid_ctas<2>(n, &ctas); budget = shape<2>().budget; break;
        case 3: err = grid_ctas<3>(n, &ctas); budget = shape<3>().budget; break;
        case 4: err = grid_ctas<4>(n, &ctas); budget = shape<4>().budget; break;
        case 5: err = grid_ctas<5>(n, &ctas); budget = shape<5>().budget; break;
        case 6: err = grid_ctas<6>(n, &ctas); budget = shape<6>().budget; break;
        case 7: err = grid_ctas<7>(n, &ctas); budget = shape<7>().budget; break;
        case 8: err = grid_ctas<8>(n, &ctas); budget = shape<8>().budget; break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    shape_out[0] = ctas;
    shape_out[1] = kClusterCtas;
    shape_out[2] = budget;
    return err;
}
