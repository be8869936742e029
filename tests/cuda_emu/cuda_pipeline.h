// CPU stand-in for the cp.async primitives of <cuda_pipeline.h> (see
// cuda_runtime.h beside it): the copy happens at once.
#pragma once

#include <cstring>

inline void __pipeline_memcpy_async(void *dst, const void *src, size_t n,
                                    size_t = 0) {
    std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
