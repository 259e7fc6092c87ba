// K2 nnue_forward_from_acc: the leaf eval from a lane's accumulator pair —
// perspective concat by side to move, clipped ReLU, the output bucket's
// 128 -> 16 -> 32 -> 1 layer stack, x600 (and the int8 fixed-point
// ladder: activations [0, 127], weights in 1/64 steps, >> 6 between
// layers, exact integer arithmetic).
//
// Replaces: fishnet_tpu/models/nnue.py:299 forward_from_acc with
// output_bucket (:275) and _bucket_weights (:280), called every search
// step at fishnet_tpu/ops/search.py:440-443.
//
// Bound on the H100: bytes at large batch — per lane the accumulator pair
// (512 B f32) in and 4 B out; the layer stack is 2,592 multiply-adds per
// lane (5.3 MFLOP at B = 1024, nothing against 67 TFLOP/s of f32), and the
// 8 buckets' weights (84 KiB f32) stay in L1/L2. At the main path's
// batches the launch itself dominates.
//
// Design: one thread per lane, 128 lanes a block. A thread streams its own
// accumulator pair through the first layer (each column is read once per
// hidden unit, from L1) and keeps the 16 + 32 hidden activations in
// registers. Float sums run in input order with fused multiply-adds, which
// differs from the reference's XLA dot in the last bits: the f32 eval is
// held to its plain version within a stated tolerance, the int8 eval
// exactly.
#include "common.cuh"

namespace {

constexpr int L1 = 64;
constexpr int IN = 2 * L1;
constexpr int H1 = 16;
constexpr int H2 = 32;
constexpr int THREADS = 128;
constexpr int QA = 127;
constexpr int QW_SHIFT = 6;
constexpr float OUTPUT_SCALE = 600.0f;
// OUTPUT_SCALE / (QA * QW) rounded once to f32, as the reference does
constexpr float INT8_SCALE = (float)(600.0 / (127.0 * 64.0));

__device__ __forceinline__ float crelu(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ int clip_qa(int x) { return min(max(x, 0), QA); }

__global__ void forward_f32(const float* __restrict__ acc,
                            const int32_t* __restrict__ stm,
                            const int32_t* __restrict__ bucket,
                            const float* __restrict__ l1_w,
                            const float* __restrict__ l1_b,
                            const float* __restrict__ l2_w,
                            const float* __restrict__ l2_b,
                            const float* __restrict__ out_w,
                            const float* __restrict__ out_b,
                            float* __restrict__ out, int batch) {
    int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= batch) return;
    int s = stm[lane], b = bucket[lane];
    const float* own = acc + ((int64_t)lane * 2 + s) * L1;
    const float* opp = acc + ((int64_t)lane * 2 + (1 - s)) * L1;
    const float* w1 = l1_w + (int64_t)b * IN * H1;
    float h1[H1];
    for (int j = 0; j < H1; ++j) h1[j] = 0.0f;
    for (int k = 0; k < IN; ++k) {
        float x = crelu(k < L1 ? own[k] : opp[k - L1]);
        for (int j = 0; j < H1; ++j) h1[j] = fmaf(x, w1[k * H1 + j], h1[j]);
    }
    for (int j = 0; j < H1; ++j) h1[j] = crelu(h1[j] + l1_b[b * H1 + j]);
    const float* w2 = l2_w + (int64_t)b * H1 * H2;
    float h2[H2];
    for (int j = 0; j < H2; ++j) h2[j] = 0.0f;
    for (int k = 0; k < H1; ++k)
        for (int j = 0; j < H2; ++j) h2[j] = fmaf(h1[k], w2[k * H2 + j], h2[j]);
    float o = 0.0f;
    for (int k = 0; k < H2; ++k)
        o = fmaf(crelu(h2[k] + l2_b[b * H2 + k]), out_w[b * H2 + k], o);
    out[lane] = (o + out_b[b]) * OUTPUT_SCALE;
}

__global__ void forward_i8(const int32_t* __restrict__ acc,
                           const int32_t* __restrict__ stm,
                           const int32_t* __restrict__ bucket,
                           const int8_t* __restrict__ l1_w,
                           const int32_t* __restrict__ l1_b,
                           const int8_t* __restrict__ l2_w,
                           const int32_t* __restrict__ l2_b,
                           const int8_t* __restrict__ out_w,
                           const int32_t* __restrict__ out_b,
                           float* __restrict__ out, int batch) {
    int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= batch) return;
    int s = stm[lane], b = bucket[lane];
    const int32_t* own = acc + ((int64_t)lane * 2 + s) * L1;
    const int32_t* opp = acc + ((int64_t)lane * 2 + (1 - s)) * L1;
    const int8_t* w1 = l1_w + (int64_t)b * IN * H1;
    int h1[H1];
    for (int j = 0; j < H1; ++j) h1[j] = 0;
    for (int k = 0; k < IN; ++k) {
        int x = clip_qa(k < L1 ? own[k] : opp[k - L1]);
        for (int j = 0; j < H1; ++j) h1[j] += x * (int)w1[k * H1 + j];
    }
    for (int j = 0; j < H1; ++j) h1[j] = clip_qa((h1[j] + l1_b[b * H1 + j]) >> QW_SHIFT);
    const int8_t* w2 = l2_w + (int64_t)b * H1 * H2;
    int h2[H2];
    for (int j = 0; j < H2; ++j) h2[j] = 0;
    for (int k = 0; k < H1; ++k)
        for (int j = 0; j < H2; ++j) h2[j] += h1[k] * (int)w2[k * H2 + j];
    int o = 0;
    for (int k = 0; k < H2; ++k)
        o += clip_qa((h2[k] + l2_b[b * H2 + k]) >> QW_SHIFT) * (int)out_w[b * H2 + k];
    out[lane] = (float)(o + out_b[b]) * INT8_SCALE;
}

}  // namespace

// acc (batch, 2, 64), stm/bucket (batch,) int32; weights of the shipped
// net's shape: l1_w (8, 128, 16), l1_b (8, 16), l2_w (8, 16, 32),
// l2_b (8, 32), out_w (8, 32), out_b (8,) → out (batch,) f32
FISHNET_EXPORT int nnue_forward_from_acc_f32(
        const void* acc, const void* stm, const void* bucket, const void* l1_w,
        const void* l1_b, const void* l2_w, const void* l2_b, const void* out_w,
        const void* out_b, void* out, int batch, void* stream) {
    int grid = (batch + THREADS - 1) / THREADS;
    forward_f32<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)acc, (const int32_t*)stm, (const int32_t*)bucket,
        (const float*)l1_w, (const float*)l1_b, (const float*)l2_w,
        (const float*)l2_b, (const float*)out_w, (const float*)out_b,
        (float*)out, batch);
    return (int)cudaGetLastError();
}

FISHNET_EXPORT int nnue_forward_from_acc_i8(
        const void* acc, const void* stm, const void* bucket, const void* l1_w,
        const void* l1_b, const void* l2_w, const void* l2_b, const void* out_w,
        const void* out_b, void* out, int batch, void* stream) {
    int grid = (batch + THREADS - 1) / THREADS;
    forward_i8<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)acc, (const int32_t*)stm, (const int32_t*)bucket,
        (const int8_t*)l1_w, (const int32_t*)l1_b, (const int8_t*)l2_w,
        (const int32_t*)l2_b, (const int8_t*)out_w, (const int32_t*)out_b,
        (float*)out, batch);
    return (int)cudaGetLastError();
}
