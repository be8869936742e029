// Kernel E: Huffman pack of zigzag levels into unescaped scan words, one
// thread per frame.
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/entropy_encode_async_pallas.py:encode_layout_async_dense
//     (the complete chain's encoder), and
//   amv_tpu/kernels/entropy_encode_pallas.py:_encode_layout (its lockstep
//     twin, used by the fallbacks).
// Token semantics are those of encode_dc + the token loop of
// amv_encode_frame (amv_tpu/native/entropy.c:786-832): DC predictors start
// at 128 per component (Y over blocks 0-3 of each MCU, Cb block 4, Cr block
// 5), DC difference category + mantissa, AC run/size with a ZRL per 16
// zeros, a negative mantissa is val - 1 masked to its size, and no EOB
// after slot 63.  A symbol absent from a table emits its size, 0 bits, as
// the C encoder does.
// Output: words[f, :] hold the scan MSB-first, so byte i of the scan is
// ((uint32)w[i >> 2]) >> (24 - 8 * (i & 3)) -- what amv_escape_frames reads
// (entropy.c:360-386); the 1-pad is left to it.  bits[f] is the exact bit
// count.  Past w_out words the thread keeps counting bits but drops the
// words, and ok[f] = 0: an overflow is reported, never truncated silently.
//
// What bounds it: the bit packing is serial within a frame (each token's
// position depends on every earlier token), so each thread runs a dependent
// chain of table lookups and shifts per coefficient; about 128 bytes of
// levels in per block and a few hundred bytes of words out per frame keep
// memory far from the limit.  Design: one thread per frame (frames are
// independent), the bit writer of bitwriter.cuh (a 64-bit accumulator
// flushed a 32-bit word at a time, shared with kernel P), the code/size
// tables in shared memory.  The TPU kernel's lockstep lanes,
// windows and budgets are gone.  A token-offset prefix sum across threads
// is the known next step (ROADMAP); this first kernel is the direct
// transcription of the C encoder.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitwriter.cuh"

namespace {

constexpr int kTabInts = 2 * 4 * 256;   // [code|size][DC-L, DC-C, AC-L, AC-C][sym]

__device__ __forceinline__ int bitlen(uint32_t v) { return v ? 32 - __clz(v) : 0; }

__global__ void encode_levels_kernel(const int16_t *__restrict__ levels,
                                     int n_frames, int n_blocks,
                                     const int *__restrict__ tables, int w_out,
                                     int32_t *__restrict__ words,
                                     int32_t *__restrict__ bits,
                                     uint8_t *__restrict__ ok) {
    __shared__ int tab[kTabInts];
    for (int i = threadIdx.x; i < kTabInts; i += blockDim.x)
        tab[i] = tables[i];
    __syncthreads();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= n_frames) return;
    const int *code = tab, *size = tab + 4 * 256;

    BitWriter bw{words + (long long)f * w_out, w_out, 0, 0, 0, 0};
    const int16_t *lv = levels + (long long)f * n_blocks * 64;
    int last_dc[3] = {128, 128, 128};
    for (int b = 0; b < n_blocks; b++) {
        const int t = b % 6;
        const bool luma = t < 4;
        const int comp = luma ? 0 : t - 3;
        const int dct = luma ? 0 : 256, act = luma ? 512 : 768;
        const int16_t *blk = lv + (long long)b * 64;
        const int dc = blk[0];
        const int diff = dc - last_dc[comp];
        last_dc[comp] = dc;
        {
            const int mag = diff < 0 ? -diff : diff;
            const int nb = bitlen((uint32_t)mag);
            bw.put(size[dct + nb], (uint32_t)code[dct + nb]);
            bw.put(nb, (uint32_t)(diff < 0 ? diff - 1 : diff));
        }
        int run = 0;
        for (int i = 1; i < 64; i++) {
            const int val = blk[i];
            if (!val) { run++; continue; }
            for (; run >= 16; run -= 16)
                bw.put(size[act + 0xF0], (uint32_t)code[act + 0xF0]);
            const int mag = val < 0 ? -val : val;
            const int nb = bitlen((uint32_t)mag);
            const int sym = ((run << 4) | nb) & 255;
            bw.put(size[act + sym], (uint32_t)code[act + sym]);
            bw.put(nb, (uint32_t)(val < 0 ? val - 1 : val));
            run = 0;
        }
        if (blk[63] == 0) bw.put(size[act], (uint32_t)code[act]);   // EOB
    }
    bw.flush();
    bits[f] = (int32_t)bw.total;
    ok[f] = (uint8_t)(bw.total <= 32ll * w_out);
}

}  // namespace

extern "C" int amv_encode_levels(const void *levels, int n_frames,
                                 int n_blocks, const void *tables, int w_out,
                                 void *words, void *bits, void *ok,
                                 void *stream) {
    if (n_frames > 0) {
        const int threads = 64;
        encode_levels_kernel<<<(n_frames + threads - 1) / threads, threads, 0,
                               (cudaStream_t)stream>>>(
            (const int16_t *)levels, n_frames, n_blocks, (const int *)tables,
            w_out, (int32_t *)words, (int32_t *)bits, (uint8_t *)ok);
    }
    return (int)cudaGetLastError();
}
