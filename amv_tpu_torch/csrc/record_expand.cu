// Kernel X: expand the record IR of kernel R into dense zigzag levels, one
// warp per frame.
//
// Replaces the Pallas kernel
//   amv_tpu/kernels/entropy_async_pallas.py:_expand_records (lanes = blocks,
//     an OR-accumulate over each block's records), and the XLA glue of
//     decode_scans_async_layout (:497-546) that regrouped the records by
//     block: a batched searchsorted, a rank sort and contiguous-run gathers.
// On the TPU that glue was gather-bound (about 30 ns an element).  Here a
// record's block is the inclusive count of is_dc records before it along
// its frame, minus 1 (:518-519), which a warp computes 32 records at a time
// with a ballot and a popcount, carrying the count from step to step; then
// every record with its write bit set stores its level at levels[f, block,
// wpos].  Within a block the writes go to strictly increasing slots (a DC
// at 0, each AC past the last), so every (block, slot) is written at most
// once and the order of the stores does not matter; the levels start
// zeroed (the wrapper's torch.zeros).  A frame's records past counts[f] are
// not read: kernel R leaves them 0.
//
// Layout: records record-major [T, F] (kernel R's coalesced stores), so a
// warp's 32 loads of one frame fall in 32 lines; the warps of neighbouring
// frames read the same lines, which L2 serves.  What bounds it: the records
// a frame holds (4 bytes each) and the scattered 2-byte level stores; a
// warp's steps are its frame's records / 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // frames per thread block

__global__ void __launch_bounds__(32 * kWarps)
expand_records_kernel(const int32_t *__restrict__ recs, long long t_rows,
                      const int32_t *__restrict__ counts, int n_frames,
                      int n_blocks, int16_t *__restrict__ levels) {
    const int lane = threadIdx.x & 31;
    const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (f >= n_frames) return;
    long long n = counts[f];
    n = n < 0 ? 0 : (n > t_rows ? t_rows : n);
    const unsigned below = (2u << lane) - 1u;       // lanes 0..lane
    int16_t *out = levels + (long long)f * n_blocks * 64;
    int blocks = 0;                                 // is_dc records so far
    for (long long t0 = 0; t0 < n; t0 += 32) {
        const long long t = t0 + lane;
        const int32_t rec = t < n ? recs[t * n_frames + f] : 0;
        const unsigned dc = __ballot_sync(0xFFFFFFFFu, (rec >> 7) & 1);
        const int b = blocks + __popc(dc & below) - 1;
        if (((rec >> 6) & 1) && b >= 0 && b < n_blocks)
            out[(long long)b * 64 + (rec & 63)] = (int16_t)(rec >> 16);
        blocks += __popc(dc);
    }
}

}  // namespace

extern "C" int amv_expand_records(const void *recs, long long t_rows,
                                  const void *counts, int n_frames,
                                  int n_blocks, void *levels, void *stream) {
    if (n_frames > 0) {
        expand_records_kernel<<<(n_frames + kWarps - 1) / kWarps,
                                32 * kWarps, 0, (cudaStream_t)stream>>>(
            (const int32_t *)recs, t_rows, (const int32_t *)counts, n_frames,
            n_blocks, (int16_t *)levels);
    }
    return (int)cudaGetLastError();
}
