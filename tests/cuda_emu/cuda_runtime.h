// A CPU stand-in for the parts of the CUDA runtime and device language that
// the port's kernels use, so that a kernel source (amv_tpu_torch/csrc/*.cu)
// compiles with g++ and runs on the CPU: every CTA's threads run as
// std::threads, one CTA at a time; __syncthreads and __syncwarp are
// std::barriers, the warp shuffles exchange through a per-warp buffer
// between two warp barriers, and a thread that returns drops out of both
// barriers (as an exited thread does on the card).  __shared__ variables
// become function statics, shared by the running CTA's threads.
//
// tests/test_torch_cuda_emulated.py compiles a source against this
// directory (-I) after rewriting each `kernel<<<grid, block, smem,
// stream>>>(args)` into `amv_emu::launch(kernel, grid, block, smem, stream,
// args)`, and holds the result against the kernel's plain torch version.
// It proves the kernel's logic, not its speed, nor what nvcc makes of it.

#pragma once

#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __constant__
#define __shared__ static
#define __forceinline__ inline
#define __restrict__ __restrict
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

typedef void *cudaStream_t;
typedef int cudaError_t;
inline cudaError_t cudaGetLastError() { return 0; }

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

using std::max;
using std::min;

namespace amv_emu {

struct Block {
    std::unique_ptr<std::barrier<>> all;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    std::vector<std::array<uint64_t, 32>> xchg;
    std::atomic<int> vote{0};
};

inline thread_local Block *blk = nullptr;
inline thread_local dim3 tid, bid;
inline dim3 bdim, gdim;

template <class K, class... A>
void launch(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t,
            A... args) {
    const unsigned n = block.x * block.y * block.z;
    gdim = grid;
    bdim = block;
    for (unsigned b = 0; b < grid.x * grid.y * grid.z; b++) {
        Block cta;
        cta.all = std::make_unique<std::barrier<>>(n);
        for (unsigned w = 0; w < (n + 31) / 32; w++)
            cta.warps.push_back(std::make_unique<std::barrier<>>(
                std::min(32u, n - 32 * w)));
        cta.xchg.resize((n + 31) / 32);
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; t++)
            threads.emplace_back([&, t, b] {
                blk = &cta;
                tid = dim3(t % block.x, t / block.x % block.y,
                           t / (block.x * block.y));
                bid = dim3(b % grid.x, b / grid.x % grid.y,
                           b / (grid.x * grid.y));
                kernel(args...);
                cta.all->arrive_and_drop();
                cta.warps[t / 32]->arrive_and_drop();
            });
        for (auto &th : threads) th.join();
    }
}

inline unsigned linear() {
    return tid.x + bdim.x * (tid.y + bdim.y * tid.z);
}

template <class T>
T exchange(T v, int src_lane) {
    const unsigned t = linear(), w = t / 32;
    uint64_t bits = 0;
    std::memcpy(&bits, &v, sizeof(T));
    blk->xchg[w][t % 32] = bits;
    blk->warps[w]->arrive_and_wait();
    bits = blk->xchg[w][src_lane];
    blk->warps[w]->arrive_and_wait();
    T r;
    std::memcpy(&r, &bits, sizeof(T));
    return r;
}

}  // namespace amv_emu

#define threadIdx amv_emu::tid
#define blockIdx amv_emu::bid
#define blockDim amv_emu::bdim
#define gridDim amv_emu::gdim

inline void __syncthreads() { amv_emu::blk->all->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
    amv_emu::blk->warps[amv_emu::linear() / 32]->arrive_and_wait();
}
inline int __syncthreads_or(int p) {
    auto *b = amv_emu::blk;
    b->all->arrive_and_wait();
    if (p) b->vote.fetch_or(1);
    b->all->arrive_and_wait();
    const int r = b->vote.load();
    b->all->arrive_and_wait();
    if (amv_emu::linear() == 0) b->vote.store(0);
    return r;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
    return amv_emu::exchange(v, src & 31);
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned d) {
    const int lane = amv_emu::linear() % 32;
    return amv_emu::exchange(v, lane >= (int)d ? lane - (int)d : lane);
}
template <class T>
T __ldg(const T *p) { return *p; }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const uint64_t v = (uint64_t)y << 32 | x;
    unsigned r = 0;
    for (int n = 0; n < 4; n++)
        r |= (unsigned)(v >> (8 * ((s >> (4 * n)) & 7)) & 0xff) << (8 * n);
    return r;
}
