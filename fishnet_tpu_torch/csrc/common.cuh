// Shared by the kernels of this directory: board768 feature indexing and
// the C-interface conventions (every entry point returns cudaGetLastError()
// after its launch, so the Python wrapper can raise on a refused launch).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define FISHNET_EXPORT extern "C" __attribute__((visibility("default")))

// board768 feature row of one piece (code 1..12) on sq, seen from
// `persp`: own pieces are kinds 0..5, the opponent's 6..11, and black's
// view flips ranks (models/nnue.py feature_index_768).
__device__ __forceinline__ int feature_768(int code, int sq, int persp) {
    int pt = (code - 1) % 6;
    int color = code <= 6 ? 0 : 1;
    int kind = color == persp ? pt : 6 + pt;
    return kind * 64 + (sq ^ (persp ? 56 : 0));
}
