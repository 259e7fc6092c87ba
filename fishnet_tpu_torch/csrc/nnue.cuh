// The board768 net's per-lane bodies as device functions: the layer stack
// from an accumulator pair (K2) and one column of the incremental
// accumulator update (K3). K2's and K3's kernels wrap them one lane (one
// column) a thread; the segment kernel (K11) calls the same functions, so
// its f32 evals and accumulators are K2's and K3's bit for bit.
#pragma once
#include "common.cuh"

namespace nnue {

constexpr int L1 = 64;  // K2's widths: the shipped net's
constexpr int IN = 2 * L1;
constexpr int H1 = 16;
constexpr int H2 = 32;
constexpr int QA = 127;
constexpr int QW_SHIFT = 6;
constexpr float OUTPUT_SCALE = 600.0f;
// OUTPUT_SCALE / (QA * QW) rounded once to f32, as the reference does
constexpr float INT8_SCALE = (float)(600.0 / (127.0 * 64.0));
constexpr int SLOTS = 4;  // piece changes a move makes
constexpr int NONE = 1 << 20;

// The output buckets' head weights: l1_w (8, IN, H1), l1_b (8, H1), l2_w
// (8, H1, H2), l2_b (8, H2), out_w (8, H2), out_b (8,).
template <typename W, typename B>
struct Head {
    const W* l1_w;
    const B* l1_b;
    const W* l2_w;
    const B* l2_b;
    const W* out_w;
    const B* out_b;
};

__device__ __forceinline__ float crelu(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ int clip_qa(int x) { return min(max(x, 0), QA); }

// K2's body on the f32 net: own/opp are the side to move's and the other
// side's L1 accumulator columns, b the output bucket. Sums run in input
// order with fused multiply-adds; one thread computes the whole lane.
__device__ __forceinline__ float forward_lane(const float* own, const float* opp, int b,
                                              const Head<float, float>& w) {
    const float* w1 = w.l1_w + (int64_t)b * IN * H1;
    float h1[H1];
    for (int j = 0; j < H1; ++j) h1[j] = 0.0f;
    for (int k = 0; k < IN; ++k) {
        float x = crelu(k < L1 ? own[k] : opp[k - L1]);
        for (int j = 0; j < H1; ++j) h1[j] = fmaf(x, w1[k * H1 + j], h1[j]);
    }
    for (int j = 0; j < H1; ++j) h1[j] = crelu(h1[j] + w.l1_b[b * H1 + j]);
    const float* w2 = w.l2_w + (int64_t)b * H1 * H2;
    float h2[H2];
    for (int j = 0; j < H2; ++j) h2[j] = 0.0f;
    for (int k = 0; k < H1; ++k)
        for (int j = 0; j < H2; ++j) h2[j] = fmaf(h1[k], w2[k * H2 + j], h2[j]);
    float o = 0.0f;
    for (int k = 0; k < H2; ++k)
        o = fmaf(crelu(h2[k] + w.l2_b[b * H2 + k]), w.out_w[b * H2 + k], o);
    return (o + w.out_b[b]) * OUTPUT_SCALE;
}

// K2's body on the int8 net: the fixed-point ladder (activations [0, QA],
// weights in 1/64 steps, >> 6 between layers), exact integer arithmetic.
__device__ __forceinline__ float forward_lane(const int32_t* own, const int32_t* opp, int b,
                                              const Head<int8_t, int32_t>& w) {
    const int8_t* w1 = w.l1_w + (int64_t)b * IN * H1;
    int h1[H1];
    for (int j = 0; j < H1; ++j) h1[j] = 0;
    for (int k = 0; k < IN; ++k) {
        int x = clip_qa(k < L1 ? own[k] : opp[k - L1]);
        for (int j = 0; j < H1; ++j) h1[j] += x * (int)w1[k * H1 + j];
    }
    for (int j = 0; j < H1; ++j) h1[j] = clip_qa((h1[j] + w.l1_b[b * H1 + j]) >> QW_SHIFT);
    const int8_t* w2 = w.l2_w + (int64_t)b * H1 * H2;
    int h2[H2];
    for (int j = 0; j < H2; ++j) h2[j] = 0;
    for (int k = 0; k < H1; ++k)
        for (int j = 0; j < H2; ++j) h2[j] += h1[k] * (int)w2[k * H2 + j];
    int o = 0;
    for (int k = 0; k < H2; ++k)
        o += clip_qa((h2[k] + w.l2_b[b * H2 + k]) >> QW_SHIFT) * (int)w.out_w[b * H2 + k];
    return (float)(o + w.out_b[b]) * INT8_SCALE;
}

// K3's body: the signed sum of the <= 4 changed feature rows of one lane,
// for perspective `persp` and accumulator column `col` (the child is the
// parent's column plus this). Equal features merge into one weight (a
// chess960 castle can move a piece onto its own square: +1 and -1
// cancel, as the reference's weight vector does), and rows are added in
// the order XLA:CPU reduces the reference's 768-long contraction:
// increasing feature index, rows of one 32-row block summed in order,
// block sums added in order.
template <typename W, typename A>
__device__ __forceinline__ A acc_delta(const int32_t* codes, const int32_t* sqs,
                                       const int32_t* signs, int persp, int col, const W* ft_w,
                                       int l1) {
    int idx[SLOTS], w[SLOTS];
    for (int i = 0; i < SLOTS; ++i) {
        int code = codes[i];
        idx[i] = code > 0 ? feature_768(code, sqs[i], persp) : NONE;
        w[i] = signs[i];
    }
    for (int i = 1; i < SLOTS; ++i) {  // merge repeated features
        for (int j = 0; j < i; ++j) {
            if (idx[i] != NONE && idx[j] == idx[i]) {
                w[j] += w[i];
                idx[i] = NONE;
            }
        }
    }
    for (int i = 1; i < SLOTS; ++i) {  // insertion sort by feature index
        int ki = idx[i], wi = w[i], j = i - 1;
        while (j >= 0 && idx[j] > ki) {
            idx[j + 1] = idx[j];
            w[j + 1] = w[j];
            --j;
        }
        idx[j + 1] = ki;
        w[j + 1] = wi;
    }
    A total = 0, block = 0;
    int cur = -1;
    for (int i = 0; i < SLOTS && idx[i] != NONE; ++i) {
        if ((idx[i] >> 5) != cur) {
            total = total + block;
            block = 0;
            cur = idx[i] >> 5;
        }
        block = block + (A)ft_w[(int64_t)idx[i] * l1 + col] * (A)w[i];
    }
    return total + block;
}

}  // namespace nnue
