// Kernel A: IMA-ADPCM (AMV flavour) decode, one thread per chunk.
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/adpcm_pallas.py:decode_layout (the batched chunk
//     decode), and
//   amv_tpu/kernels/adpcm_pallas.py:decode_layout_wrap (the same over a
//     logically tiled input: output row i reads input row i % C).
// Semantics: adpcm_ima_expand_nibble with shift 3 (adpcm.c:716-740) per
// nibble, the high nibble of each byte first (adpcm.c:1281-1282), from
// the chunk's header state {predictor, step_index} with the step index
// clamped to 0..88; every payload byte decodes to two samples.
//
// What bounds it: the per-sample recurrence is serial within a chunk
// (each step needs the previous predictor and step index), so a chunk is
// a chain of 2 * nbytes dependent steps of ~15 integer operations, while
// the traffic is 5 bytes per payload byte.  At the file's shape (4,800
// chunks of 689 bytes) the chunks are only 150 warps: the time is one
// chain's latency, not the card's bandwidth.  Design: chunks are
// independent, so one thread owns one chunk and keeps its state in
// registers; the 89-entry step table sits in shared memory (the TPU's
// masked-select OR-tree existed because Mosaic has no vector gather); the
// index table is arithmetic, d < 4 ? -1 : 2d - 6.  Each payload byte's two
// samples leave as one 32-bit store.  Known weakness, kept for now: every
// thread reads and writes its own row, so neither loads nor stores
// coalesce (a later step stages rows through shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int16_t kStepTable[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767};

constexpr int kThreads = 128;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// one adpcm_ima_expand_nibble step; returns the new predictor
__device__ __forceinline__ int expand(int &p, int &s, int nib,
                                      const int *step_tab) {
    const int step = step_tab[s];
    const int d = nib & 7;
    const int diff = ((2 * d + 1) * step) >> 3;
    p = clampi((nib & 8) ? p - diff : p + diff, -32768, 32767);
    s = clampi(s + (d < 4 ? -1 : 2 * d - 6), 0, 88);
    return p;
}

__global__ void __launch_bounds__(kThreads)
adpcm_decode_kernel(const uint8_t *__restrict__ payload, long long nbytes,
                    const int32_t *__restrict__ pred,
                    const int32_t *__restrict__ sidx, long long c_in,
                    long long c_out, int16_t *__restrict__ out) {
    __shared__ int step_tab[89];
    for (int i = threadIdx.x; i < 89; i += blockDim.x)
        step_tab[i] = kStepTable[i];
    __syncthreads();
    const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (c >= c_out) return;
    const long long src = c % c_in;
    const uint8_t *row = payload + src * nbytes;
    uint32_t *dst = reinterpret_cast<uint32_t *>(out + c * 2 * nbytes);
    int p = pred[src], s = clampi(sidx[src], 0, 88);
    for (long long k = 0; k < nbytes; k++) {
        const int byte = row[k];
        const uint32_t hi = (uint16_t)expand(p, s, byte >> 4, step_tab);
        const uint32_t lo = (uint16_t)expand(p, s, byte & 15, step_tab);
        dst[k] = hi | (lo << 16);   // little-endian: the high nibble first
    }
}

}  // namespace

extern "C" int amv_adpcm_decode(const void *payload, long long nbytes,
                                const void *pred, const void *sidx,
                                long long c_in, long long c_out, void *out,
                                void *stream) {
    if (c_out > 0 && nbytes > 0) {
        const long long grid = (c_out + kThreads - 1) / kThreads;
        adpcm_decode_kernel<<<(unsigned)grid, kThreads, 0,
                              (cudaStream_t)stream>>>(
            (const uint8_t *)payload, nbytes, (const int32_t *)pred,
            (const int32_t *)sidx, c_in, c_out, (int16_t *)out);
    }
    return (int)cudaGetLastError();
}
