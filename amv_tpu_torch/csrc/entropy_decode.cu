// Kernel D: JPEG K.3 Huffman decode of unescaped AMV scans, one thread per
// frame.
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/entropy_async_pallas.py:decode_scans_async_dense (the
//     complete chain's decoder), and
//   amv_tpu/kernels/entropy_decode_pallas.py:_decode_layout (its lockstep
//     twin, the ok-gated fallback).
// Semantics are those of the scalar C decoder decode_scan_levels
// (amv_tpu/native/entropy.c:285-332): levels in zigzag order, slot 0 = the
// DC difference, ZRL for run 15 / size 0, no EOB after slot 63.  The bit
// reader is MSB-first over a 64-bit cache and zero-fills past lens[f], as
// br_fill's tail does (entropy.c:193-198); it never reads outside row f.
// ok[f] = 0 exactly where the C decoder returns an error (an invalid code,
// size 0 with run != 15, a position past 63); the frame then stops, and
// the levels decoded before the failing token stay written.
//
// What bounds it: Huffman decode is bit-serial within a frame, so each
// thread runs a dependent chain of a table lookup, a shift and a store per
// token (about 2 tokens per scan byte).  Latency, not bandwidth, bounds it;
// frames are independent, so the card is filled across frames.  Design:
// the TPU kernels' lockstep lanes, ring windows and iteration budgets
// existed for Mosaic's lack of a dynamic gather and are gone; each thread
// keeps its own bit reader, and the tables sit in shared memory: a
// 256-entry first-level table per Huffman table resolves every code of up
// to 8 bits in one lookup (entropy.c:144-147), longer codes resolve by the
// canonical maxcode/valoff walk (JPEG F.16).  The C decoder's 64K-entry
// tables would not fit in shared memory.  Rows are length-sorted by the
// caller so a warp's frames finish together.  Token count is capped at
// n_blocks * 65 + 4 * lens[f] + 64, which no input reaches (every code is
// at least 2 bits, and zero fill advances a block by one slot a token).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// per Huffman table (DC-L, DC-C, AC-L, AC-C): e1[256], maxcode[17],
// valoff[17], vals[256] -- amv_tpu_torch/codecs/amv_video.py
constexpr int kTabInts = 256 + 17 + 17 + 256;
constexpr int kAllTabInts = 4 * kTabInts;

struct BitReader {
    const uint8_t *row;
    long long len, pos;
    uint64_t cache;   // top `bits` bits valid, MSB-aligned, zero below
    int bits;

    __device__ __forceinline__ void fill() {
        while (bits <= 56) {
            uint64_t b = pos < len ? row[pos] : 0;
            pos++;
            cache |= b << (56 - bits);
            bits += 8;
        }
    }
    __device__ __forceinline__ void skip(int n) { cache <<= n; bits -= n; }
    // JPEG extend of the next n (1..16) bits; needs n valid bits
    __device__ __forceinline__ int32_t get_extend(int n) {
        uint32_t v = (uint32_t)(cache >> (64 - n));
        skip(n);
        uint32_t neg = ((v >> (n - 1)) & 1u) - 1u;
        return (int32_t)(v - (neg & ((1u << n) - 1u)));
    }
};

// Decode one symbol of table t from a filled reader; returns sym, sets
// *len (0 = invalid code).
__device__ __forceinline__ int decode_sym(const int *tab, uint32_t peek16,
                                          int *len) {
    int ent = tab[peek16 >> 8];
    if (ent) {
        *len = ent & 31;
        return ent >> 5;
    }
    const int *maxcode = tab + 256, *valoff = tab + 273, *vals = tab + 290;
    for (int L = 9; L <= 16; L++) {
        int code = (int)(peek16 >> (16 - L));
        if (code <= maxcode[L]) {
            *len = L;
            return vals[valoff[L] + code];
        }
    }
    *len = 0;
    return 0;
}

__global__ void decode_scans_kernel(const uint8_t *__restrict__ rows,
                                    long long stride,
                                    const long long *__restrict__ lens,
                                    int n_frames, int n_blocks,
                                    const int *__restrict__ tables,
                                    int16_t *__restrict__ levels,
                                    uint8_t *__restrict__ ok) {
    __shared__ int tab[kAllTabInts];
    for (int i = threadIdx.x; i < kAllTabInts; i += blockDim.x)
        tab[i] = tables[i];
    __syncthreads();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= n_frames) return;

    long long len = lens[f];
    len = len < 0 ? 0 : (len > stride ? stride : len);
    BitReader br{rows + (long long)f * stride, len, 0, 0, 0};
    int16_t *out = levels + (long long)f * n_blocks * 64;
    long long budget = (long long)n_blocks * 65 + 4 * len + 64;
    int good = 1;

    for (int b = 0; b < n_blocks && good; b++) {
        const bool luma = (b % 6) < 4;
        const int *dct = tab + (luma ? 0 : 1) * kTabInts;
        const int *act = tab + (luma ? 2 : 3) * kTabInts;
        int16_t *blk = out + (long long)b * 64;
        int len_code;
        br.fill();
        int sym = decode_sym(dct, (uint32_t)(br.cache >> 48), &len_code);
        if (!len_code || --budget < 0) { good = 0; break; }
        br.skip(len_code);
        blk[0] = (int16_t)(sym ? br.get_extend(sym) : 0);
        int i = 0;
        for (;;) {
            br.fill();
            sym = decode_sym(act, (uint32_t)(br.cache >> 48), &len_code);
            if (!len_code || --budget < 0) { good = 0; break; }
            br.skip(len_code);
            if (sym == 0) break;                       // EOB
            const int run = sym >> 4, size = sym & 15;
            if (size == 0) {
                if (run != 15) { good = 0; break; }
                i += 16;                               // ZRL
                continue;
            }
            const int32_t level = br.get_extend(size);
            i += run + 1;
            if (i > 63) { good = 0; break; }
            blk[i] = (int16_t)level;
            if (i == 63) break;                        // no EOB after 63
        }
    }
    ok[f] = (uint8_t)good;
}

}  // namespace

extern "C" int amv_decode_scans(const void *rows, long long stride,
                                const void *lens, int n_frames, int n_blocks,
                                const void *tables, void *levels, void *ok,
                                void *stream) {
    if (n_frames > 0) {
        const int threads = 64;
        decode_scans_kernel<<<(n_frames + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
            (const uint8_t *)rows, stride, (const long long *)lens,
            n_frames, n_blocks, (const int *)tables, (int16_t *)levels,
            (uint8_t *)ok);
    }
    return (int)cudaGetLastError();
}
