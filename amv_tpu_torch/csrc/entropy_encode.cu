// Kernel E: Huffman pack of zigzag levels into unescaped scan words, one
// thread block (CTA) per frame, one warp per 8x8 block.
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
// (entropy.c:360-386); the 1-pad is left to it, and the last word is
// zero-filled below its bits.  bits[f] is the exact bit count.  Past w_out
// words the bits still count but the words are dropped, and ok[f] = 0: an
// overflow is reported, never truncated silently.  The count entry
// (amv_count_bits) gives bits[f] alone.
//
// What bounds it on the H100: 295 MB of levels in at 160x120 (4,800
// frames), a few tens of MB of words out, and ~20 integer operations per
// token: bytes, 0.10 ms.  Nothing in a block's bits depends on another
// block except its DC predictor, which is the DC of a block at a fixed
// index (the previous Y block, or the same chroma block of the previous
// MCU), so the bit-serial chain of one thread per frame (the first design,
// ~1,000 cycles a token with 4,800 threads on 132 SMs) is not needed.
// Design: a CTA of 8 warps per frame; the frame's blocks go round-robin
// to the warps, so a warp works on block b while its neighbours work on b
// - 1 and b + 1, and loads its next block while it packs this one (a
// block's 64 levels are 32 words, one coalesced 128-byte load, two slots
// a lane).  Per block: two ballots give the nonzero masks of the even and
// the odd slots, from which each slot's zero run (the distance to the
// previous set bit) and its ZRLs follow; code and size tables sit in
// shared memory; each lane packs its tokens into a 64-bit string and a
// shuffle scan of the lanes' lengths gives their offsets and the block's
// bits.  The block's offset in the frame comes from the warp before it
// through shared memory (a tag and the offset, set once that warp knows
// its block's bits, before it writes), and the next block's goes to the
// warp after it, so every token is packed once.  Each lane then ORs its
// string into the <= 3 words it spans (atomicOr in shared memory: a word
// may be shared with the neighbouring lane or block; a lane with more than
// 64 bits, rare, ORs put by put).  The frame's
// words are staged in dynamic shared memory and stored coalesced at the
// end; a w_out too large for shared memory writes straight into the
// frame's row in device memory, which the CTA zeroes first -- a branch of
// the same kernel (a template parameter), not a fallback.  The count
// entry sums the blocks' bits without the hand-over or the writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTabInts = 2 * 4 * 256;   // [code|size][DC-L, DC-C, AC-L, AC-C][sym]
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// words staged in shared memory up to this many bytes (above 48 KB only as
// dynamic shared memory, after cudaFuncSetAttribute)
constexpr int kStageMax = 96 * 1024;
constexpr int kDcMax = 8192;             // blocks whose DCs shared memory holds
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ int bitlen(uint32_t v) { return 32 - __clz(v); }
__device__ __forceinline__ uint32_t low_bits(int n) {
    return n >= 32 ? kAll : (1u << n) - 1u;
}

// the DC predictor block of block b (-1: the component's first, predictor
// 128): Y over blocks 0-3 of each MCU, Cb block 4, Cr block 5
__device__ __forceinline__ int pred_block(int b) {
    const int t = b % 6;
    if (t >= 1 && t <= 3) return b - 1;
    return t == 0 ? (b >= 6 ? b - 3 : -1) : (b >= 6 ? b - 6 : -1);
}

// A block as its warp sees it: tables, the nonzero masks of the even AC
// slots (bit j: slot 2 j, j > 0) and of the odd ones (bit j: slot 2 j + 1)
struct Block {
    const int *code, *size;
    int dct, act;         // table offsets of the block's component
    uint32_t m0, m1;
};

// the nearest nonzero AC slot before slot s, or 0 (the DC)
__device__ __forceinline__ int prev_nonzero(const Block &k, int s) {
    const uint32_t e = k.m0 & low_bits((s + 1) >> 1);
    const uint32_t o = k.m1 & low_bits(s >> 1);
    const int pe = e ? 2 * (31 - __clz(e)) : 0;
    const int po = o ? 2 * (31 - __clz(o)) + 1 : 0;
    return max(pe, po);
}

// One lane's share of a block: slots s = 2 * lane + h (h = 0, 1) of the
// level pair v; the DC token (lane 0, slot 0, difference dcd) and the EOB
// (lane 31, after slot 63) are the lane's too.  Emits the tokens in order
// through put(size, value) and returns their bits.
template <typename Put>
__device__ __forceinline__ int lane_tokens(const Block &k, uint32_t v,
                                           int lane, int dcd, Put put) {
    int n = 0;
#pragma unroll
    for (int h = 0; h < 2; h++) {
        const int s = 2 * lane + h;
        const int val = (int)(int16_t)(h ? (v >> 16) : (v & 0xFFFF));
        if (s == 0) {
            const int mag = dcd < 0 ? -dcd : dcd;
            const int nb = mag ? bitlen((uint32_t)mag) : 0;
            const int sz = k.size[k.dct + nb];
            put(sz, (uint32_t)k.code[k.dct + nb]);
            put(nb, (uint32_t)(dcd < 0 ? dcd - 1 : dcd));
            n += sz + nb;
            continue;
        }
        if (!val) continue;
        const int run = s - prev_nonzero(k, s) - 1;
        const int zs = k.size[k.act + 0xF0];
        for (int z = 0; z < (run >> 4); z++) {
            put(zs, (uint32_t)k.code[k.act + 0xF0]);
            n += zs;
        }
        const int mag = val < 0 ? -val : val;
        const int nb = bitlen((uint32_t)mag);
        const int sym = (((run & 15) << 4) | nb) & 255;
        const int sz = k.size[k.act + sym];
        put(sz, (uint32_t)k.code[k.act + sym]);
        put(nb, (uint32_t)(val < 0 ? val - 1 : val));
        n += sz + nb;
    }
    if (lane == 31 && (v >> 16) == 0) {                 // EOB after slot < 63
        const int sz = k.size[k.act];
        put(sz, (uint32_t)k.code[k.act]);
        n += sz;
    }
    return n;
}

// A lane's writer for strings longer than 64 bits: bits from absolute
// offset `pos`, ORed into words[< w_out] a word at a time (the first
// word's leading bits are the zeros it starts with).
struct OrWriter {
    uint32_t *words;
    int w_out;
    long long w;         // word the pending bits belong to
    uint64_t acc;        // low n bits pending
    int n;

    __device__ __forceinline__ void put(int size, uint32_t v) {
        if (!size) return;
        acc = (acc << size) | (uint64_t)(v & low_bits(size));
        n += size;
        if (n >= 32) {
            n -= 32;
            const uint32_t word = (uint32_t)(acc >> n);
            if (w < w_out && word) atomicOr(words + w, word);
            w++;
            acc &= (1ull << n) - 1ull;
        }
    }
    __device__ __forceinline__ void flush() {
        if (n > 0 && w < w_out) {
            const uint32_t word = (uint32_t)(acc << (32 - n));
            if (word) atomicOr(words + w, word);
        }
    }
};

// block b of the frame as its warp sees it, from the level pair v of the
// lane: the block's masks and tables, lane 0's DC difference (the frame's
// DCs are in shared memory, dcs, or in device memory when dcs is null)
__device__ __forceinline__ Block see_block(const int16_t *lv16,
                                           const int16_t *dcs, const int *tab,
                                           int b, int lane, uint32_t v,
                                           int &dcd) {
    dcd = 0;
    if (lane == 0) {
        const int pb = pred_block(b);
        dcd = (int)(int16_t)(v & 0xFFFF) -
              (pb < 0 ? 128 : dcs ? (int)dcs[pb]
                                  : (int)__ldg(lv16 + (long long)pb * 64));
    }
    const bool luma = b % 6 < 4;
    return Block{tab, tab + 4 * 256, luma ? 0 : 256, luma ? 512 : 768,
                 __ballot_sync(kAll, lane && (v & 0xFFFF)),
                 __ballot_sync(kAll, (v >> 16) != 0)};
}

// Write a block whose bits start at absolute offset base: the lane's
// string acc of n bits (valid when n <= 64) at offset pos ORs into the <= 3
// words it spans (a word may be shared with the neighbouring lane or
// block).
__device__ __forceinline__ void write_block(const Block &k, uint32_t v,
                                            int lane, int dcd, int n,
                                            uint64_t acc, long long pos,
                                            uint32_t *out, int w_out) {
    if (__any_sync(kAll, n > 64)) {                  // rare: ORs put by put
        OrWriter wr{out, w_out, pos >> 5, 0, (int)(pos & 31)};
        lane_tokens(k, v, lane, dcd, [&wr](int sz, uint32_t val) {
            wr.put(sz, val);
        });
        wr.flush();
        return;
    }
    if (!n) return;
    const uint64_t msb = acc << (64 - n);            // the string, MSB-aligned
    const int sh = (int)(pos & 31);
    const long long w = pos >> 5;
    const uint64_t x = msb >> sh;                    // words w and w + 1
    const uint32_t c[3] = {(uint32_t)(x >> 32), (uint32_t)x,
                           sh ? (uint32_t)((msb << (64 - sh)) >> 32) : 0u};
#pragma unroll
    for (int i = 0; i < 3; i++)
        if (c[i] && w + i < w_out) atomicOr(out + w + i, c[i]);
}

template <bool kWrite, bool kStaged>
__global__ void __launch_bounds__(kThreads)
encode_levels_kernel(const int16_t *__restrict__ levels, int n_blocks,
                     const int *__restrict__ tables, int w_out,
                     int32_t *__restrict__ words, int32_t *__restrict__ bits,
                     uint8_t *__restrict__ ok) {
    // the words (staged), then the frame's DCs (when n_blocks <= kDcMax)
    extern __shared__ uint32_t staged[];
    __shared__ int tab[kTabInts];
    // the hand-over of block offsets: warp w reads block b's offset (b % 8
    // == w) from slot w once its tag is b, and leaves block b + 1's in slot
    // w + 1
    __shared__ long long slot_base[kWarps];
    __shared__ volatile int slot_tag[kWarps];
    __shared__ long long warp_bits[kWarps];
    const int f = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < kTabInts; i += kThreads) tab[i] = tables[i];
    uint32_t *out = nullptr;
    if (kWrite) {
        out = kStaged ? staged
                      : reinterpret_cast<uint32_t *>(words) + (long long)f * w_out;
        for (int i = threadIdx.x; i < w_out; i += kThreads) out[i] = 0;
    }
    if (threadIdx.x < kWarps) {
        slot_base[threadIdx.x] = 0;
        slot_tag[threadIdx.x] = threadIdx.x ? -1 : 0;
    }
    const uint32_t *lv32 = reinterpret_cast<const uint32_t *>(levels) +
                           (long long)f * n_blocks * 32;
    const int16_t *lv16 = levels + (long long)f * n_blocks * 64;
    int16_t *dcs = n_blocks <= kDcMax ? reinterpret_cast<int16_t *>(
                                           staged + (kStaged ? w_out : 0))
                                      : nullptr;
    if (dcs)
        for (int i = threadIdx.x; i < n_blocks; i += kThreads)
            dcs[i] = __ldg(lv16 + (long long)i * 64);
    __syncthreads();

    long long mine = 0;                   // the bits of this warp's blocks
    uint32_t v = warp < n_blocks ? __ldg(lv32 + (long long)warp * 32 + lane)
                                 : 0u;
    for (int b = warp; b < n_blocks; b += kWarps) {
        const uint32_t vk = v;            // the next block's load in flight
        if (b + kWarps < n_blocks)
            v = __ldg(lv32 + (long long)(b + kWarps) * 32 + lane);
        int dcd;
        const Block blk = see_block(lv16, dcs, tab, b, lane, vk, dcd);
        if (!kWrite) {
            mine += __reduce_add_sync(
                kAll, lane_tokens(blk, vk, lane, dcd, [](int, uint32_t) {}));
            continue;
        }
        uint64_t acc = 0;
        const int n = lane_tokens(blk, vk, lane, dcd,
                                  [&acc](int sz, uint32_t val) {
            acc = (acc << sz) | (uint64_t)(val & low_bits(sz));
        });
        int incl = n;                                // lanes' inclusive scan
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(kAll, incl, d);
            if (lane >= d) incl += y;
        }
        const int total = __shfl_sync(kAll, incl, 31);
        // this block's offset from the warp before, the next block's to
        // the warp after
        long long base = 0;
        if (lane == 0) {
            while (slot_tag[warp] != b) __nanosleep(20);
            __threadfence_block();
            base = slot_base[warp];
            const int nx = warp + 1 == kWarps ? 0 : warp + 1;
            slot_base[nx] = base + total;
            __threadfence_block();
            slot_tag[nx] = b + 1;
        }
        base = __shfl_sync(kAll, base, 0);
        write_block(blk, vk, lane, dcd, n, acc, base + incl - n, out, w_out);
        mine += total;
    }
    if (lane == 0) warp_bits[warp] = mine;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long all = 0;
        for (int w = 0; w < kWarps; w++) all += warp_bits[w];
        bits[f] = (int32_t)all;
        if (kWrite) ok[f] = (uint8_t)(all <= 32ll * w_out);
    }
    if (kWrite && kStaged) {
        int32_t *row = words + (long long)f * w_out;
        for (int i = threadIdx.x; i < w_out; i += kThreads)
            row[i] = (int32_t)staged[i];
    }
}

template <bool kWrite, bool kStaged>
int launch(const void *levels, int n_frames, int n_blocks, const void *tables,
           int w_out, void *words, void *bits, void *ok, void *stream) {
    const size_t smem = (kStaged ? (size_t)w_out * 4 : 0) +
                        (n_blocks <= kDcMax ? (size_t)n_blocks * 2 : 0);
    auto kernel = encode_levels_kernel<kWrite, kStaged>;
    // with the static tables, above 48 KB only after the attribute
    if (smem + sizeof(int) * kTabInts > 40 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<n_frames, kThreads, smem, (cudaStream_t)stream>>>(
        (const int16_t *)levels, n_blocks, (const int *)tables, w_out,
        (int32_t *)words, (int32_t *)bits, (uint8_t *)ok);
    return (int)cudaGetLastError();
}

}  // namespace

// words need not be zeroed: the kernel writes every word of every row.
extern "C" int amv_encode_levels(const void *levels, int n_frames,
                                 int n_blocks, const void *tables, int w_out,
                                 void *words, void *bits, void *ok,
                                 void *stream) {
    if (n_frames <= 0) return 0;
    if ((long long)w_out * 4 <= kStageMax)
        return launch<true, true>(levels, n_frames, n_blocks, tables, w_out,
                                  words, bits, ok, stream);
    return launch<true, false>(levels, n_frames, n_blocks, tables, w_out,
                               words, bits, ok, stream);
}

// bits[f] alone: phases 1 and 2, no words.
extern "C" int amv_count_bits(const void *levels, int n_frames, int n_blocks,
                              const void *tables, void *bits, void *stream) {
    if (n_frames <= 0) return 0;
    return launch<false, false>(levels, n_frames, n_blocks, tables, 0,
                                nullptr, bits, nullptr, stream);
}
