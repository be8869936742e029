// Kernel X: expand the record IR of kernel R into dense zigzag levels, a
// thread block (CTA) per frame, each level written once.
//
// Replaces the Pallas kernel
//   amv_tpu/kernels/entropy_async_pallas.py:_expand_records (lanes = blocks,
//     an OR-accumulate over each block's records), and the XLA glue of
//     decode_scans_async_layout (:497-546) that regrouped the records by
//     block: a batched searchsorted, a rank sort and contiguous-run gathers.
// On the TPU that glue was gather-bound (about 30 ns an element).  Here a
// record's block is the inclusive count of is_dc records before it along
// its frame, minus 1 (:518-519); every record with its write bit set puts
// its level at levels[f, block, wpos].  Within a block the writes go to
// strictly increasing slots (a DC at 0, each AC past the last), so every
// (block, slot) is written at most once and their order does not matter;
// every slot no record writes is 0.  A frame's records past counts[f] are
// not read.
//
// What bounds it on the H100: the bytes, the used records read once (4
// bytes each) and the levels written once (128 bytes a block).  The design:
// the frame's CTA takes its records in tiles of kThreads x 4, each thread
// one 16-byte load of 4 records, the next tile loaded while this one is
// placed.  Each record's block comes from a scan of is_dc over the tile (a
// ballot and a popcount a record slot within the warp, then the warps'
// counts through shared memory) and a count carried from tile to tile.
// The levels are assembled in a window of kWindow blocks in shared memory,
// zeroed there: a tile's written records land in the window, and when a
// tile reaches past it, the window is complete (the blocks never decrease
// along a frame), so it is stored as whole 128-byte lines by coalesced
// 16-byte stores, zeroed, moved on, and the same tile placed again.  A tile
// may span many windows (a frame of DC records only) or a window many
// tiles (runs of ZRLs).  Blocks no record reaches (a frame that is not ok,
// the tail past the last DC record) are stored as zeros, so every slot of
// the output is written once and the wrapper allocates with torch.empty.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // a CTA, one frame
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                  // records a thread a tile
constexpr int kTile = kThreads * kPer;
constexpr int kWindow = 128;             // blocks staged: 16 KB of levels
constexpr unsigned kAll = 0xFFFFFFFFu;

// The tile of records at t0 (this thread's 4 at t0 + 4 * tid); records at
// or past n read as 0 (no block, no write).  vec: 16-byte loads are aligned.
__device__ __forceinline__ int4 load_tile(const int32_t *__restrict__ row,
                                          long long t0, long long n,
                                          bool vec) {
    const long long at = t0 + kPer * threadIdx.x;
    int4 v = make_int4(0, 0, 0, 0);
    if (at >= n) return v;
    if (vec) {
        v = __ldg((const int4 *)(row + at));
        if (at + 1 >= n) v.y = 0;
        if (at + 2 >= n) v.z = 0;
        if (at + 3 >= n) v.w = 0;
    } else {
        v.x = row[at];
        if (at + 1 < n) v.y = row[at + 1];
        if (at + 2 < n) v.z = row[at + 2];
        if (at + 3 < n) v.w = row[at + 3];
    }
    return v;
}

// Store the window's blocks wb .. min(wb + kWindow, n_blocks) - 1 and zero
// the whole window (each thread its own 16-byte vectors).
__device__ __forceinline__ void flush(int4 *win, int4 *__restrict__ out,
                                      int wb, int n_blocks) {
    const int n_vec = 8 * min(kWindow, n_blocks - wb);
    int4 *dst = out + 8LL * wb;
    for (int i = threadIdx.x; i < 8 * kWindow; i += kThreads) {
        const int4 v = win[i];
        win[i] = make_int4(0, 0, 0, 0);
        if (i < n_vec) dst[i] = v;
    }
}

__global__ void __launch_bounds__(kThreads)
expand_records_kernel(const int32_t *__restrict__ recs, long long t_rows,
                      bool vec, const int32_t *__restrict__ counts,
                      int n_blocks, int16_t *__restrict__ levels) {
    __shared__ int4 win4[8 * kWindow];
    __shared__ int part[2][kWarps];
    int16_t *win = reinterpret_cast<int16_t *>(win4);
    const int f = blockIdx.x, lane = threadIdx.x & 31,
              warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;      // lanes before this one
    const int32_t *row = recs + (long long)f * t_rows;
    int4 *out = reinterpret_cast<int4 *>(levels + (long long)f * n_blocks * 64);
    long long n = counts[f];
    n = n < 0 ? 0 : (n > t_rows ? t_rows : n);
    for (int i = threadIdx.x; i < 8 * kWindow; i += kThreads)
        win4[i] = make_int4(0, 0, 0, 0);
    int wb = 0;        // the window's first block
    int carry = 0;     // is_dc records before the tile
    int p = 0;         // which half of part this tile's counts use
    int4 next = load_tile(row, 0, n, vec);
    __syncthreads();
    for (long long t0 = 0; t0 < n && wb < n_blocks; t0 += kTile) {
        const int4 v = next;
        if (t0 + kTile < n) next = load_tile(row, t0 + kTile, n, vec);
        const int r[kPer] = {v.x, v.y, v.z, v.w};
        // the is_dc records before each record: those of the warps before
        // (their counts through part), of the lanes before (a ballot a
        // record slot) and of the thread's own records before it
        int before = 0, in_warp = 0;
#pragma unroll
        for (int k = 0; k < kPer; k++) {
            const unsigned dc = __ballot_sync(kAll, (r[k] >> 7) & 1);
            before += __popc(dc & below);
            in_warp += __popc(dc);
        }
        if (lane == 0) part[p][warp] = in_warp;
        __syncthreads();
        int total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; w++) {
            const int c = part[p][w];
            before += w < warp ? c : 0;
            total += c;
        }
        p ^= 1;
        int blk[kPer];
        int run = carry + before - 1;
#pragma unroll
        for (int k = 0; k < kPer; k++) {
            run += (r[k] >> 7) & 1;
            blk[k] = run;
        }
        carry += total;
        const int last = carry - 1;        // the tile's last record's block
        for (;;) {
#pragma unroll
            for (int k = 0; k < kPer; k++) {
                const unsigned o = (unsigned)(blk[k] - wb);
                if (((r[k] >> 6) & 1) && o < kWindow)
                    win[o * 64 + (r[k] & 63)] = (int16_t)(r[k] >> 16);
            }
            if (last < wb + kWindow) break;
            // the tile reaches past the window: the window is complete
            __syncthreads();
            flush(win4, out, wb, n_blocks);
            wb += kWindow;
            __syncthreads();
            if (wb >= n_blocks) break;
        }
    }
    __syncthreads();
    if (wb < n_blocks) {
        flush(win4, out, wb, n_blocks);
        wb += kWindow;
    }
    // blocks past the last window any record reached
    const int4 zero = make_int4(0, 0, 0, 0);
    for (long long i = 8LL * wb + threadIdx.x; i < 8LL * n_blocks;
         i += kThreads)
        out[i] = zero;
}

}  // namespace

extern "C" int amv_expand_records(const void *recs, long long t_rows,
                                  const void *counts, int n_frames,
                                  int n_blocks, void *levels, void *stream) {
    if (n_frames > 0 && n_blocks > 0) {
        const bool vec = (uintptr_t)recs % 16 == 0 && t_rows % kPer == 0;
        expand_records_kernel<<<n_frames, kThreads, 0,
                                (cudaStream_t)stream>>>(
            (const int32_t *)recs, t_rows, vec, (const int32_t *)counts,
            n_blocks, (int16_t *)levels);
    }
    return (int)cudaGetLastError();
}
