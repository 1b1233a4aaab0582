// Reading a query's chars backwards, shared by the seed-scan and exact-search kernels.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sahara {

// The chars of a query row read backwards from one char, a 32-bit aligned
// word at a time.  A word is loaded only while chars of the query remain,
// so every word read holds a char of the query (an aligned word never
// crosses a page, so the first one may start before the row).
struct BackStream {
    const uint32_t* word;  // the aligned word that holds the next char
    uint32_t cur;
    int byte;  // the next char's byte in cur

    BackStream() = default;

    __device__ __forceinline__ explicit BackStream(const uint8_t* last) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(last);
        word = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
        cur = __ldg(word);
        byte = static_cast<int>(a & 3);
    }

    // The next char; `more` says whether another char of the query follows.
    __device__ __forceinline__ int next(bool more) {
        const int c = static_cast<int>((cur >> (8 * byte)) & 0xFFu);
        if (byte == 0 && more) cur = __ldg(--word);
        byte = (byte - 1) & 3;
        return c;
    }
};

}  // namespace sahara
