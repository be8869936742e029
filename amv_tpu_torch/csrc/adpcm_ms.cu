// Kernel M: the MS-ADPCM expand of WAVE input (adpcm.c:743-756), a thread
// per lane.
//
// Not the port of a Pallas kernel: the JAX package runs this expand as one
// jax.lax.scan over the samples (amv_tpu/kernels/adpcm.py:225
// decode_ms_nibbles), which XLA compiles into a single device loop; the
// port's plain version is a torch loop of ~14 launches a sample.
// Semantics, as the JAX package's (int32 wraps as C's `int` does): per
// nibble n of a lane, from the block header's state (s1, s2, idelta) and
// coefficients (c1, c2),
//   p  = (s1 c1 + s2 c2) wrapped to int32, then / 256 toward zero
//        ((p + ((p >> 31) & 255)) >> 8);
//   s1' = clip(p + signed(n) idelta, -32768, 32767), the sum wrapped;
//   idelta' = max((adapt[n] idelta) wrapped >> 8, 16);  s2' = s1;
// and the output sample is s1'.  Products and sums are formed in uint32
// and cast back, which is the two's-complement wrap.
//
// What bounds it: a lane is a serial recurrence of ~12 integer operations
// a sample; the card holds 12,998 lanes of 2,034 samples at phase 12's
// shape, so the latency of one lane's 2,034 dependent steps (~0.05 ms) is
// the floor, beside 1 byte in and 2 out a sample (0.024 ms at 3.35 TB/s).
// Design: a warp of 32 lanes a CTA (so the 406 warps spread over the 132
// SMs), the lanes' rows staged through shared memory in tiles of kTile
// samples: the warp reads each row's tile with consecutive bytes on
// consecutive threads, each thread walks its own row from shared memory,
// and the warp writes the int16 tile back row by row, coalesced.  The
// adaptation table sits in shared memory (its index differs per lane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;

__constant__ int32_t kAdapt[16] = {230, 230, 230, 230, 307, 409, 512, 614,
                                   768, 614, 512, 409, 307, 230, 230, 230};

__global__ void __launch_bounds__(32)
ms_expand_kernel(const uint8_t *__restrict__ nib, long long b, long long n,
                 const int32_t *__restrict__ coeff1,
                 const int32_t *__restrict__ coeff2,
                 const int32_t *__restrict__ idelta,
                 const int32_t *__restrict__ sample1,
                 const int32_t *__restrict__ sample2,
                 int16_t *__restrict__ out) {
    // rows of kTile + 4 bytes and kTile + 2 halves: odd word strides
    __shared__ uint8_t s_nib[32][kTile + 4];
    __shared__ int16_t s_out[32][kTile + 2];
    __shared__ int32_t s_adapt[16];
    const int lane = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * 32;
    const int rows = (int)min(32LL, b - row0);
    if (lane < 16) s_adapt[lane] = kAdapt[lane];
    const long long row = row0 + min(lane, rows - 1);
    int c1 = coeff1[row], c2 = coeff2[row], idl = idelta[row];
    int s1 = sample1[row], s2 = sample2[row];
    for (long long t0 = 0; t0 < n; t0 += kTile) {
        const int cnt = (int)min((long long)kTile, n - t0);
        __syncwarp();
        for (int r = 0; r < rows; ++r) {
            const uint8_t *src = nib + (row0 + r) * n + t0;
            for (int k = lane; k < cnt; k += 32) s_nib[r][k] = src[k];
        }
        __syncwarp();
        for (int k = 0; k < cnt; ++k) {
            const int v = s_nib[lane][k] & 15;
            int p = (int)((uint32_t)s1 * (uint32_t)c1 +
                          (uint32_t)s2 * (uint32_t)c2);
            p = (p + ((p >> 31) & 255)) >> 8;
            const int sv = v & 8 ? v - 16 : v;
            p = (int)((uint32_t)p + (uint32_t)sv * (uint32_t)idl);
            s2 = s1;
            s1 = min(max(p, -32768), 32767);
            idl = max((int)((uint32_t)s_adapt[v] * (uint32_t)idl) >> 8, 16);
            s_out[lane][k] = (int16_t)s1;
        }
        __syncwarp();
        for (int r = 0; r < rows; ++r) {
            int16_t *dst = out + (row0 + r) * n + t0;
            for (int k = lane; k < cnt; k += 32) dst[k] = s_out[r][k];
        }
    }
}

}  // namespace

// nib uint8 [b, n] (0..15, emit order), coeff1, coeff2, idelta, sample1,
// sample2 int32 [b]; out int16 [b, n].
extern "C" int amv_ms_expand(const void *nib, long long b, long long n,
                             const void *coeff1, const void *coeff2,
                             const void *idelta, const void *sample1,
                             const void *sample2, void *out, void *stream) {
    if (b > 0 && n > 0)
        ms_expand_kernel<<<(unsigned)((b + 31) / 32), 32, 0,
                           (cudaStream_t)stream>>>(
            (const uint8_t *)nib, b, n, (const int32_t *)coeff1,
            (const int32_t *)coeff2, (const int32_t *)idelta,
            (const int32_t *)sample1, (const int32_t *)sample2,
            (int16_t *)out);
    return (int)cudaGetLastError();
}
