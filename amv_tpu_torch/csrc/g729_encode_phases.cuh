// Kernel K's time by phase.  Built with -DK_PHASES (tools/time_g729.py's
// profile build of a K source), thread 0 of each CTA reads clock64() after
// the barrier that ends each phase and adds the cycles since its last
// stamp to that phase's count; at the kernel's end it adds its CTA's
// counts into g_phase_cycles, which amv_g729_encode_phases() copies out
// and clears.  K_SYNC() is a barrier only in that build, where a phase
// has none of its own at its end.  Without K_PHASES every macro is empty
// and the kernel is the one the library ships.

#pragma once

#ifdef K_PHASES

constexpr int kMaxPhases = 32;

struct PhaseClock {
    long long last, cyc[kMaxPhases];
};

__device__ unsigned long long g_phase_cycles[kMaxPhases];

#define K_PHASE_CLOCK PhaseClock clk;
#define K_SYNC() __syncthreads()
#define K_CLOCK_START(S)                                                  \
    do {                                                                  \
        if (threadIdx.x == 0) {                                           \
            for (int p_ = 0; p_ < kMaxPhases; ++p_) (S).clk.cyc[p_] = 0;  \
            (S).clk.last = clock64();                                     \
        }                                                                 \
    } while (0)
#define K_STAMP(S, p)                                                     \
    do {                                                                  \
        if (threadIdx.x == 0) {                                           \
            const long long now_ = clock64();                             \
            (S).clk.cyc[p] += now_ - (S).clk.last;                        \
            (S).clk.last = now_;                                          \
        }                                                                 \
    } while (0)
#define K_CLOCK_END(S)                                                    \
    do {                                                                  \
        if (threadIdx.x == 0)                                             \
            for (int p_ = 0; p_ < kMaxPhases; ++p_)                       \
                atomicAdd(&g_phase_cycles[p_],                            \
                          (unsigned long long)(S).clk.cyc[p_]);           \
    } while (0)
// the C entries of the profile build: the phases' names (comma-separated,
// in stamp order) and their cycles summed over the CTAs since the last
// call (copied to out[kMaxPhases], then cleared)
#define K_PHASE_ENTRIES(names)                                            \
    extern "C" const char *amv_g729_encode_phase_names() { return names; } \
    extern "C" int amv_g729_encode_phases(void *out) {                    \
        cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)); \
        const unsigned long long zero[kMaxPhases] = {};                   \
        cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));           \
        return (int)cudaGetLastError();                                   \
    }

#else

#define K_PHASE_CLOCK
#define K_SYNC()
#define K_CLOCK_START(S)
#define K_STAMP(S, p)
#define K_CLOCK_END(S)
#define K_PHASE_ENTRIES(names)

#endif
