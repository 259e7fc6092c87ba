// K14 nnue_stack_backward: the backward pass through the board768 layer
// stack of a training batch. From the saved accumulators it recomputes each
// sample's forward (crelu, 128 -> 16, crelu, 16 -> 32, crelu, -> 1) with its
// output bucket's weights, backpropagates d_pred x 600, and writes the
// accumulators' gradient d_acc (B, 2, 64) by side to move, as
// forward_from_acc reads them, and the per-bucket gradients of l1_w, l1_b,
// l2_w, l2_b, out_w and out_b summed over the batch.
//
// Replaces: the layer stack's part of jax.value_and_grad(loss_fn) inside
// fishnet_tpu/models/train.py:47 make_train_step (the gradient of
// models/nnue.py:299 forward_from_acc with :275 output_bucket and :280
// _bucket_weights).
//
// The clip rule: the reference's derivative of jnp.clip(z, 0, 1) is 1
// strictly inside (0, 1), 0.5 on either edge and 0 outside (max and min
// each split a tie evenly). It applies at all three clips: each
// accumulator, and the two hidden layers. Edges occur in practice: a
// bucket whose inputs all clip to 0 has its hidden pre-activation equal to
// its bias, which is exactly 0 at init.
//
// Bound on the H100: bytes, and those are tiny. At B = 512 it reads the
// accumulators (256 KiB) and writes d_acc (256 KiB) and 83 KiB of weight
// gradients: ~0.2 us of HBM time, so its floor is the launch latency of its
// two kernels.
//
// Design, two passes, no float atomics (two launches on the same inputs
// give the same bytes):
//   1. one warp per sample (4 a block): a lane holds the inputs 32 apart
//      (4 of 128) and one layer-2 unit (H2 = 32); the first layer's sums
//      and the gradient into the first layer are xor-butterfly warp sums
//      (the same bits in every lane). It recomputes the forward, runs the
//      backward, and writes d_acc and a per-sample row of the hidden
//      activations and their gradients (h1, dz1, h2, dz2, d_out) to
//      scratch. Its sums run in another order than K2's forward, which
//      moves a pre-activation by its last bits; a pre-activation lands
//      exactly on an edge only where its sum is exact (all-zero inputs, a
//      bias alone), and such a sum is the same in any order;
//   2. one thread per weight-gradient element (21,128 at the shipped
//      widths): it walks the batch in index order and adds the terms of the
//      samples in its bucket, a fixed order.
// Every product and add is an explicit __fmul_rn/__fadd_rn, so nothing is
// contracted into a fused multiply-add.
#include "nnue.cuh"

namespace {

using nnue::H1;
using nnue::H2;
using nnue::IN;
using nnue::L1;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;  // samples a block in the first pass
constexpr int PER_LANE = IN / 32;  // inputs a lane holds
static_assert(IN % 32 == 0 && H2 == 32, "a warp holds the inputs 32 apart, a lane a layer-2 unit");
constexpr int BUCKETS = 8;
// a sample's scratch row: h1, dz1, h2, dz2, d_out
constexpr int S_H1 = 0;
constexpr int S_DZ1 = S_H1 + H1;
constexpr int S_H2 = S_DZ1 + H1;
constexpr int S_DZ2 = S_H2 + H2;
constexpr int S_DOUT = S_DZ2 + H2;
constexpr int SCRATCH_W = S_DOUT + 1;
// the head gradient buffer: each field over all buckets, in field order
constexpr int G_W1 = 0;
constexpr int G_B1 = G_W1 + BUCKETS * IN * H1;
constexpr int G_W2 = G_B1 + BUCKETS * H1;
constexpr int G_B2 = G_W2 + BUCKETS * H1 * H2;
constexpr int G_OW = G_B2 + BUCKETS * H2;
constexpr int G_OB = G_OW + BUCKETS * H2;
constexpr int G_TOTAL = G_OB + BUCKETS;

// d/dz clip(z, 0, 1) as the reference takes it
__device__ __forceinline__ float crelu_grad(float z) {
    if (z > 0.0f && z < 1.0f) return 1.0f;
    return (z == 0.0f || z == 1.0f) ? 0.5f : 0.0f;
}

__global__ void sample_kernel(const float* __restrict__ acc, const int32_t* __restrict__ stm,
                              const int32_t* __restrict__ bucket,
                              const float* __restrict__ d_pred, nnue::Head<float, float> w,
                              float* __restrict__ d_acc, float* __restrict__ scratch,
                              int batch) {
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (s >= batch) return;  // the whole warp: one sample
    const int st = stm[s], b = bucket[s];
    const float* own = acc + ((int64_t)s * 2 + st) * L1;
    const float* opp = acc + ((int64_t)s * 2 + (1 - st)) * L1;
    // the lane's inputs k = lane + 32 r: the side to move's columns, then the other's
    float pre[PER_LANE], x[PER_LANE];
    for (int r = 0; r < PER_LANE; ++r) {
        const int k = lane + 32 * r;
        pre[r] = k < L1 ? own[k] : opp[k - L1];
        x[r] = nnue::crelu(pre[r]);
    }
    // forward: every lane ends with all of z1 (xor-butterfly sums) and its own z2
    const float* w1 = w.l1_w + (int64_t)b * IN * H1;
    float z1[H1], h1[H1];
    for (int j = 0; j < H1; ++j) {
        float part = 0.0f;
        for (int r = 0; r < PER_LANE; ++r)
            part = __fadd_rn(part, __fmul_rn(x[r], w1[(lane + 32 * r) * H1 + j]));
        z1[j] = __fadd_rn(nnue::warp_sum(part), w.l1_b[b * H1 + j]);
        h1[j] = nnue::crelu(z1[j]);
    }
    const float* w2 = w.l2_w + (int64_t)b * H1 * H2;
    float z2 = 0.0f;
    for (int j = 0; j < H1; ++j) z2 = __fadd_rn(z2, __fmul_rn(h1[j], w2[j * H2 + lane]));
    z2 = __fadd_rn(z2, w.l2_b[b * H2 + lane]);
    // backward
    const float d_out = __fmul_rn(d_pred[s], nnue::OUTPUT_SCALE);
    const float dz2 = __fmul_rn(__fmul_rn(w.out_w[b * H2 + lane], d_out), crelu_grad(z2));
    float dz1[H1];
    for (int j = 0; j < H1; ++j)
        dz1[j] = __fmul_rn(nnue::warp_sum(__fmul_rn(w2[j * H2 + lane], dz2)), crelu_grad(z1[j]));
    for (int r = 0; r < PER_LANE; ++r) {
        const int k = lane + 32 * r;
        float d = 0.0f;
        for (int j = 0; j < H1; ++j) d = __fadd_rn(d, __fmul_rn(w1[k * H1 + j], dz1[j]));
        const int p = k < L1 ? st : 1 - st;
        d_acc[((int64_t)s * 2 + p) * L1 + (k % L1)] = __fmul_rn(d, crelu_grad(pre[r]));
    }
    float* row = scratch + (int64_t)s * SCRATCH_W;
    row[S_H2 + lane] = nnue::crelu(z2);
    row[S_DZ2 + lane] = dz2;
    if (lane == 0) {
        for (int j = 0; j < H1; ++j) {
            row[S_H1 + j] = h1[j];
            row[S_DZ1 + j] = dz1[j];
        }
        row[S_DOUT] = d_out;
    }
}

__global__ void reduce_kernel(const float* __restrict__ acc, const int32_t* __restrict__ stm,
                              const int32_t* __restrict__ bucket,
                              const float* __restrict__ scratch, float* __restrict__ grad,
                              int batch) {
    int o = blockIdx.x * THREADS + threadIdx.x;
    if (o >= G_TOTAL) return;
    float sum = 0.0f;
    if (o < G_B1) {  // l1_w[b, k, j]: x_k * dz1_j
        int b = o / (IN * H1), k = (o / H1) % IN, j = o % H1;
        for (int s = 0; s < batch; ++s) {
            if (bucket[s] != b) continue;
            int p = k < L1 ? stm[s] : 1 - stm[s];
            float x = nnue::crelu(acc[((int64_t)s * 2 + p) * L1 + (k % L1)]);
            sum = __fadd_rn(sum, __fmul_rn(x, scratch[(int64_t)s * SCRATCH_W + S_DZ1 + j]));
        }
    } else if (o < G_W2) {  // l1_b[b, j]: dz1_j
        int b = (o - G_B1) / H1, j = (o - G_B1) % H1;
        for (int s = 0; s < batch; ++s)
            if (bucket[s] == b) sum = __fadd_rn(sum, scratch[(int64_t)s * SCRATCH_W + S_DZ1 + j]);
    } else if (o < G_B2) {  // l2_w[b, j, k]: h1_j * dz2_k
        int r = o - G_W2, b = r / (H1 * H2), j = (r / H2) % H1, k = r % H2;
        for (int s = 0; s < batch; ++s) {
            if (bucket[s] != b) continue;
            const float* row = scratch + (int64_t)s * SCRATCH_W;
            sum = __fadd_rn(sum, __fmul_rn(row[S_H1 + j], row[S_DZ2 + k]));
        }
    } else if (o < G_OW) {  // l2_b[b, k]: dz2_k
        int b = (o - G_B2) / H2, k = (o - G_B2) % H2;
        for (int s = 0; s < batch; ++s)
            if (bucket[s] == b) sum = __fadd_rn(sum, scratch[(int64_t)s * SCRATCH_W + S_DZ2 + k]);
    } else if (o < G_OB) {  // out_w[b, k]: h2_k * d_out
        int b = (o - G_OW) / H2, k = (o - G_OW) % H2;
        for (int s = 0; s < batch; ++s) {
            if (bucket[s] != b) continue;
            const float* row = scratch + (int64_t)s * SCRATCH_W;
            sum = __fadd_rn(sum, __fmul_rn(row[S_H2 + k], row[S_DOUT]));
        }
    } else {  // out_b[b]: d_out
        int b = o - G_OB;
        for (int s = 0; s < batch; ++s)
            if (bucket[s] == b) sum = __fadd_rn(sum, scratch[(int64_t)s * SCRATCH_W + S_DOUT]);
    }
    grad[o] = sum;
}

}  // namespace

// acc (batch, 2, 64) f32, stm/bucket (batch,) int32, d_pred (batch,) f32;
// the shipped net's head: l1_w (8, 128, 16), l1_b (8, 16), l2_w (8, 16,
// 32), l2_b (8, 32), out_w (8, 32), out_b (8,) → d_acc (batch, 2, 64) and
// grad (21,128) f32: the six fields' gradients in that order; scratch
// (batch, 97) f32, a row per sample (kernels.py STACK_SCRATCH_W)
FISHNET_EXPORT int nnue_stack_backward(
        const void* acc, const void* stm, const void* bucket, const void* d_pred,
        const void* l1_w, const void* l1_b, const void* l2_w, const void* l2_b,
        const void* out_w, const void* out_b, void* d_acc, void* grad, void* scratch,
        int batch, void* stream) {
    nnue::Head<float, float> head{(const float*)l1_w, (const float*)l1_b, (const float*)l2_w,
                                  (const float*)l2_b, (const float*)out_w, (const float*)out_b,
                                  L1, H1, H2};
    cudaStream_t s = (cudaStream_t)stream;
    if (batch > 0) {
        sample_kernel<<<(batch + WARPS - 1) / WARPS, THREADS, 0, s>>>(
            (const float*)acc, (const int32_t*)stm, (const int32_t*)bucket,
            (const float*)d_pred, head, (float*)d_acc, (float*)scratch, batch);
        int rc = (int)cudaGetLastError();
        if (rc) return rc;
    }
    reduce_kernel<<<(G_TOTAL + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        (const float*)acc, (const int32_t*)stm, (const int32_t*)bucket,
        (const float*)scratch, (float*)grad, batch);
    return (int)cudaGetLastError();
}
