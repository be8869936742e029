// Kernel P: pack Huffman records into unescaped scan words, one thread per
// lane.
//
// Replaces the Pallas kernel
//   amv_tpu/kernels/entropy_encode_async_pallas.py:_pack_records (the record
//     pair's packer, also the rechunk encoder's splice).
// A record is code << 5 | len (len 0..31, code < 2^len, at most 27 bits):
// a Huffman code with its mantissa appended (the tokenizer's records), or a
// 26-bit piece of a block's bitstream (the rechunk encoder's).  Lane l
// appends records 0 .. min(totals[l], T) - 1 of its row in order; its
// words are big-endian, the tail zero-filled, bits[l] = the sum of the
// lengths; past w_out words the writer keeps counting and drops the words,
// as the TPU kernel does (its caller tests bits against w_out).
//
// What bounds it: each record's position depends on every earlier one, so a
// lane is a serial chain of shifts and ORs (the bit writer of
// bitwriter.cuh); with one lane per frame the frames with the most records
// set the time.  The records are read frame-major [L, T], each
// thread streaming its own row through L1.  The TPU kernel's lockstep
// iteration, 128-bit register buffer and windowed word emit are gone.  A
// record-parallel pack (an exclusive scan of the lengths, then each record
// ORed into its one or two words) is the redesign queued in ROADMAP.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitwriter.cuh"

namespace {

__global__ void pack_records_kernel(const int32_t *__restrict__ recs,
                                    long long t_cols,
                                    const int32_t *__restrict__ totals,
                                    int n_lanes, int w_out,
                                    int32_t *__restrict__ words,
                                    int32_t *__restrict__ bits) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= n_lanes) return;
    BitWriter bw{words + (long long)l * w_out, w_out, 0, 0, 0, 0};
    const int32_t *row = recs + (long long)l * t_cols;
    long long n = totals[l];
    n = n < 0 ? 0 : (n > t_cols ? t_cols : n);
    for (long long t = 0; t < n; t++) {
        const uint32_t rec = (uint32_t)row[t];
        bw.put((int)(rec & 31u), (rec >> 5) & 0x7FFFFFFu);
    }
    bw.flush();
    bits[l] = (int32_t)bw.total;
}

}  // namespace

extern "C" int amv_pack_records(const void *recs, long long t_cols,
                                const void *totals, int n_lanes, int w_out,
                                void *words, void *bits, void *stream) {
    if (n_lanes > 0) {
        const int threads = 64;
        pack_records_kernel<<<(n_lanes + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
            (const int32_t *)recs, t_cols, (const int32_t *)totals, n_lanes,
            w_out, (int32_t *)words, (int32_t *)bits);
    }
    return (int)cudaGetLastError();
}
