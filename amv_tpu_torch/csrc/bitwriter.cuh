// The MSB-first bit writer of kernel P (record_pack.cu): one thread
// appends codes to its own row of big-endian 32-bit words, so byte i of
// the stream is ((uint32)w[i >> 2]) >> (24 - 8 * (i & 3)) -- what
// amv_escape_frames reads (entropy.c:360-386).  A 64-bit
// accumulator holds the pending low `n` bits and leaves a word at a time.
// Past w_out words the writer keeps counting bits but drops the words, so
// an overflow is reported by the count, never truncated silently.

#pragma once

#include <stdint.h>

namespace {

struct BitWriter {
    int32_t *row;
    int w_out, w;
    uint64_t acc;     // low `n` bits pending
    int n;
    long long total;

    // append the low `size` (0..32) bits of v
    __device__ __forceinline__ void put(int size, uint32_t v) {
        acc = (acc << size) | (uint64_t)(v & ((size >= 32) ? 0xFFFFFFFFu
                                                           : ((1u << size) - 1u)));
        n += size;
        total += size;
        if (n >= 32) {
            n -= 32;
            if (w < w_out) row[w] = (int32_t)(uint32_t)(acc >> n);
            w++;
            acc &= (n ? ((1ull << n) - 1ull) : 0ull);
        }
    }
    // the last partial word, zero-filled below its bits
    __device__ __forceinline__ void flush() {
        if (n > 0) {
            if (w < w_out) row[w] = (int32_t)(uint32_t)(acc << (32 - n));
            w++;
        }
    }
};

}  // namespace
