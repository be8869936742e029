// Kernel P: pack Huffman records into unescaped scan words, a thread block
// (CTA) per lane, the records packed in parallel.
//
// Replaces the Pallas kernel
//   amv_tpu/kernels/entropy_encode_async_pallas.py:_pack_records (the record
//     pair's packer, also the rechunk encoder's splice).
// A record is code << 5 | len (len 0..31, code < 2^len, at most 27 bits):
// a Huffman code with its mantissa appended (the tokenizer's records), or a
// 26-bit piece of a block's bitstream (the rechunk encoder's).  Lane l
// appends records 0 .. min(totals[l], T) - 1 of its row in order; its
// words are big-endian, so byte i of the stream is ((uint32)w[i >> 2]) >>
// (24 - 8 * (i & 3)) -- what amv_escape_frames reads (entropy.c:360-386);
// the tail is zero-filled, bits[l] = the sum of the lengths; past w_out
// words the bits still count and the words are dropped, as the TPU kernel
// does (its caller tests bits against w_out).
//
// What bounds it on the H100: the bytes, the records read once (4 bytes
// each) and the words written once.  A record's bit offset is the sum of
// the lengths before it, so a serial bit writer, one thread a lane, is a
// chain of ~6,450 dependent shifts and ORs a frame at the main shapes and
// latency-bound (4,800 such chains on 132 SMs ran at 45x the byte bound).
// Nothing else links the records, so the design packs them in parallel,
// as the plain version computes them: the lane's CTA takes the records in
// chunks of kThreads x 4, each thread one 16-byte load of 4 records; a
// scan of the lengths (warp shuffles, then the warps' sums through shared
// memory) gives each record its offset, carried from chunk to chunk; each
// record is ORed into the one or two words it spans in a window of words
// in shared memory (atomicOr: a word may hold the bits of several
// records, as kernel E's words do); the window's completed words are
// stored coalesced, and its partial last word is carried to the next
// chunk.  The CTA then stores the last word and zeroes the rest of the
// row, so the wrapper allocates with torch.empty.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // a CTA, one lane
constexpr int kPer = 4;               // records a thread a chunk
constexpr int kChunk = kThreads * kPer;
// the words a chunk's bits touch: at most 31 bits a record after the
// carried partial word, and the word after the last
constexpr int kWin = (31 + 31 * kChunk) / 32 + 2;
constexpr unsigned kAll = 0xFFFFFFFFu;

// The exclusive prefix sum of v over the CTA's threads; *total gets the
// sum.  part: a word a warp of shared memory, free until the next barrier.
__device__ __forceinline__ int cta_scan(int v, int *part, int *total) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kAll, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) part[w] = x;
    __syncthreads();
    int before = 0, sum = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; k++) {
        const int p = part[k];
        before += k < w ? p : 0;
        sum += p;
    }
    *total = sum;
    return before + x - v;
}

// OR the low len (1..31) bits of code into the big-endian words of win at
// bit offset at
__device__ __forceinline__ void or_bits(uint32_t *win, int at, int len,
                                        uint32_t code) {
    const int e = (at & 31) + len, w = at >> 5;
    if (e <= 32) {
        atomicOr(win + w, code << (32 - e));
    } else {
        atomicOr(win + w, code >> (e - 32));
        atomicOr(win + w + 1, code << (64 - e));
    }
}

__global__ void __launch_bounds__(kThreads)
pack_records_kernel(const int32_t *__restrict__ recs, long long t_cols,
                    bool vec, const int32_t *__restrict__ totals,
                    int w_out, int32_t *__restrict__ words,
                    int32_t *__restrict__ bits) {
    __shared__ uint32_t win[kWin];
    __shared__ int part[kThreads / 32];
    const int l = blockIdx.x, tid = threadIdx.x;
    for (int i = tid; i < kWin; i += kThreads) win[i] = 0;
    const int32_t *row = recs + (long long)l * t_cols;
    int32_t *out = words + (long long)l * w_out;
    long long n = totals[l];
    n = n < 0 ? 0 : (n > t_cols ? t_cols : n);
    long long bit = 0;                  // the bits before the chunk
    __syncthreads();
    for (long long c0 = 0; c0 < n; c0 += kChunk) {
        const long long at = c0 + kPer * tid;
        int4 v = make_int4(0, 0, 0, 0);
        if (vec && at < n) {
            v = __ldg((const int4 *)(row + at));
        } else if (at < n) {
            v.x = row[at];
            if (at + 1 < n) v.y = row[at + 1];
            if (at + 2 < n) v.z = row[at + 2];
            if (at + 3 < n) v.w = row[at + 3];
        }
        uint32_t r[kPer] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                            (uint32_t)v.w};
        int sum = 0;
#pragma unroll
        for (int k = 0; k < kPer; k++) {
            if (at + k >= n) r[k] = 0;
            sum += (int)(r[k] & 31u);
        }
        int total;
        int off = (int)(bit & 31) + cta_scan(sum, part, &total);
#pragma unroll
        for (int k = 0; k < kPer; k++) {
            const int len = (int)(r[k] & 31u);
            if (len)
                or_bits(win, off, len,
                        (r[k] >> 5) & 0x7FFFFFFu & ((1u << len) - 1u));
            off += len;
        }
        __syncthreads();
        // the window's completed words out, its partial word carried
        const int full = ((int)(bit & 31) + total) >> 5;
        const long long base = bit >> 5;
        for (int i = tid; i < full; i += kThreads)
            if (base + i < w_out) out[base + i] = (int32_t)win[i];
        const uint32_t carry = win[full];
        __syncthreads();
        for (int i = tid; i <= full; i += kThreads) win[i] = i ? 0u : carry;
        bit += total;
        __syncthreads();
    }
    // the last partial word (0 if none) and the zero tail
    for (long long i = (bit >> 5) + tid; i < w_out; i += kThreads)
        out[i] = i == (bit >> 5) ? (int32_t)win[0] : 0;
    if (tid == 0) bits[l] = (int32_t)bit;
}

}  // namespace

extern "C" int amv_pack_records(const void *recs, long long t_cols,
                                const void *totals, int n_lanes, int w_out,
                                void *words, void *bits, void *stream) {
    if (n_lanes > 0) {
        // 16-byte loads where every row starts on a 16-byte boundary
        const bool vec = t_cols % 4 == 0 && (uintptr_t)recs % 16 == 0;
        pack_records_kernel<<<n_lanes, kThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t *)recs, t_cols, vec, (const int32_t *)totals,
            w_out, (int32_t *)words, (int32_t *)bits);
    }
    return (int)cudaGetLastError();
}
