// Kernel D: JPEG K.3 Huffman decode of unescaped AMV scans, one thread per
// frame; and kernel R, the same token walk emitting the record IR.
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

// Kernel R replaces amv_tpu/kernels/entropy_async_pallas.py:_decode_records
// (the record-IR decoder): per frame, one 32-bit record per token,
// level << 16 | is_dc << 7 | write << 6 | wpos (entropy_async_pallas.py:
// 308-311), stored record-major [t_rows, F] so that a warp's stores of one
// token row coalesce; rows past a frame's last token stay 0.  Its semantics
// are JAX's, not the C decoder's: a code no table holds reads as length 16
// and the table's last symbol (the threshold decode's clip), size 0 with
// run != 15 writes a 0 level, a position past 63 ends the block, and a
// frame stops only when its blocks are done or t_rows records are spent.
// status[f] = (blocks done, records), and blocks done < n_blocks is JAX's
// not-ok.  It shares D's bit reader and symbol lookup; its token loop is
// flat (one record per iteration), which is also what makes the stores of
// a warp land in one row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// per Huffman table (DC-L, DC-C, AC-L, AC-C): e1[256], maxcode[17],
// valoff[17], vals[256] -- amv_tpu_torch/codecs/amv_video.py
constexpr int kTabInts = 256 + 17 + 17 + 256;
constexpr int kAllTabInts = 4 * kTabInts;
constexpr int kVals = 256 + 17 + 17;    // vals[] within a table

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

// The next symbol of table `tab`: fills the reader, looks the symbol up and
// consumes its code; *len = 0 for an invalid code (nothing consumed).
__device__ __forceinline__ int read_sym(BitReader &br, const int *tab,
                                        int *len) {
    br.fill();
    const int sym = decode_sym(tab, (uint32_t)(br.cache >> 48), len);
    if (*len) br.skip(*len);
    return sym;
}

// the shared-memory copy of the four tables, loaded by every thread block
__device__ __forceinline__ void load_tables(int *tab, const int *tables) {
    for (int i = threadIdx.x; i < kAllTabInts; i += blockDim.x)
        tab[i] = tables[i];
    __syncthreads();
}

__global__ void decode_scans_kernel(const uint8_t *__restrict__ rows,
                                    long long stride,
                                    const long long *__restrict__ lens,
                                    int n_frames, int n_blocks,
                                    const int *__restrict__ tables,
                                    int16_t *__restrict__ levels,
                                    uint8_t *__restrict__ ok) {
    __shared__ int tab[kAllTabInts];
    load_tables(tab, tables);
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
        int sym = read_sym(br, dct, &len_code);
        if (!len_code || --budget < 0) { good = 0; break; }
        blk[0] = (int16_t)(sym ? br.get_extend(sym) : 0);
        int i = 0;
        for (;;) {
            sym = read_sym(br, act, &len_code);
            if (!len_code || --budget < 0) { good = 0; break; }
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

__global__ void decode_records_kernel(const uint8_t *__restrict__ rows,
                                      long long stride,
                                      const long long *__restrict__ lens,
                                      int n_frames, int n_blocks,
                                      const int *__restrict__ tables,
                                      long long t_rows,
                                      int32_t *__restrict__ recs,
                                      int32_t *__restrict__ status) {
    __shared__ int tab[kAllTabInts];
    load_tables(tab, tables);
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= n_frames) return;

    long long len = lens[f];
    len = len < 0 ? 0 : (len > stride ? stride : len);
    BitReader br{rows + (long long)f * stride, len, 0, 0, 0};
    int blk = 0, pos = 0, c6 = 0;     // block, next zigzag slot, block % 6
    long long t = 0;
    for (; t < t_rows && blk < n_blocks; t++) {
        const bool is_dc = pos == 0, luma = c6 < 4;
        const int *table = tab + (is_dc ? (luma ? 0 : 1) : (luma ? 2 : 3))
                                 * kTabInts;
        int ln;
        int sym = read_sym(br, table, &ln);
        if (!ln) {                    // JAX: length 16, the last symbol
            br.skip(16);
            sym = table[kVals + (is_dc ? 11 : 161)];
        }
        const int size = is_dc ? sym : (sym & 15);   // DC vals are 0..11
        const int32_t level = size ? br.get_extend(size) : 0;
        int wpos = 0, newpos = 1;
        bool write = true;
        if (!is_dc) {
            const bool eob = sym == 0, zrl = sym == 0xF0;
            wpos = pos + (sym >> 4);
            write = !eob && !zrl && wpos <= 63;
            newpos = eob ? 64 : (zrl ? pos + 16 : wpos + 1);
        }
        recs[t * n_frames + f] = (int32_t)(
            ((uint32_t)level << 16) | ((uint32_t)is_dc << 7) |
            ((uint32_t)write << 6) | (uint32_t)min(wpos, 63));
        if (!is_dc && newpos >= 64) {
            blk++;
            c6 = c6 == 5 ? 0 : c6 + 1;
            pos = 0;
        } else {
            pos = newpos;
        }
    }
    status[2 * f] = blk;
    status[2 * f + 1] = (int32_t)t;
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

extern "C" int amv_decode_records(const void *rows, long long stride,
                                  const void *lens, int n_frames, int n_blocks,
                                  const void *tables, long long t_rows,
                                  void *recs, void *status, void *stream) {
    if (n_frames > 0) {
        const int threads = 64;
        decode_records_kernel<<<(n_frames + threads - 1) / threads, threads,
                                0, (cudaStream_t)stream>>>(
            (const uint8_t *)rows, stride, (const long long *)lens,
            n_frames, n_blocks, (const int *)tables, t_rows,
            (int32_t *)recs, (int32_t *)status);
    }
    return (int)cudaGetLastError();
}
