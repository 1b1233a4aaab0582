// Launch shape shared by the one-thread-per-item kernels.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sahara {

// SMs of the current device, read once per process (and library).
inline int sm_count() {
    static const int sms = [] {
        int dev = 0, n = 132;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
            cudaGetLastError();
            n = 132;
        }
        return n;
    }();
    return sms;
}

// Block size (a multiple of 32, at most 256) whose grid loads the busiest
// SM least: every block of these kernels is resident at once, so a kernel
// ends when its busiest SM does.  Ties go to the larger block.
inline int balanced_block(int64_t threads) {
    const int sms = sm_count();
    int best = 256;
    int64_t best_load = INT64_MAX;
    for (int bs = 32; bs <= 256; bs += 32) {
        const int64_t blocks = (threads + bs - 1) / bs;
        const int64_t load = (blocks + sms - 1) / sms * bs;
        if (load <= best_load) {
            best_load = load;
            best = bs;
        }
    }
    return best;
}

}  // namespace sahara
