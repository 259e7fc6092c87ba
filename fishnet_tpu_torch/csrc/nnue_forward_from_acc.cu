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
// 8 buckets' weights (84 KiB f32) stay in L1/L2. What limits it in
// practice is each lane's dependent chain: 128 multiply-adds in one
// hidden unit's first-layer sum, then 16 and 32.
//
// Design: one warp per lane, four lanes a block; the body is nnue.cuh
// forward_warp, which the segment kernel (K11) calls too. The warp stages
// its lane's accumulator pair in shared memory (four coalesced columns a
// thread), then thread j computes hidden unit j: its first-layer chain in
// input order with the weights loaded a chunk ahead, the second layer
// from the first's units by shuffles, the output on the shuffled second
// layer, so the lane's chain is one unit's and not all 2,592
// multiply-adds on one thread. Float sums run in input order with fused
// multiply-adds, one thread a sum, which differs from the reference's XLA
// dot in the last bits: the f32 eval is held to its plain version within
// a stated tolerance, the int8 eval exactly (its first layer splits each
// unit's sum over two threads, exact in integers). The bf16 net
// (models/nnue.py cast_params) keeps f32 accumulators and reads its bf16
// weights (42 KiB for the 8 buckets), widening each at its load: the same
// f32 arithmetic in the same order, so its eval is the f32 kernel's bits
// on the widened weights.
#include "nnue.cuh"

namespace {

constexpr int WARP = 32;
constexpr int LANES = 4;  // warps, one lane each, per block

template <typename A, typename W, typename B>
__global__ void __launch_bounds__(LANES * WARP) forward_kernel(
        const A* __restrict__ acc, const int32_t* __restrict__ stm,
        const int32_t* __restrict__ bucket, nnue::Head<W, B> head, float* __restrict__ out,
        int batch) {
    __shared__ A pairs[LANES][2 * nnue::L1];
    const int w = threadIdx.x / WARP, t = threadIdx.x % WARP;
    const int lane = blockIdx.x * LANES + w;
    if (lane >= batch) return;
    A* pair = pairs[w];
    const A* src = acc + (int64_t)lane * 2 * nnue::L1;
    for (int c = t; c < 2 * nnue::L1; c += WARP) pair[c] = src[c];
    __syncwarp();
    const int s = stm[lane];
    const float ev = nnue::forward_warp(pair + s * nnue::L1, pair + (1 - s) * nnue::L1,
                                        bucket[lane], head, t);
    if (t == 0) out[lane] = ev;
}

template <typename A, typename W, typename B>
int launch(const void* acc, const void* stm, const void* bucket, const void* l1_w,
           const void* l1_b, const void* l2_w, const void* l2_b, const void* out_w,
           const void* out_b, void* out, int batch, void* stream) {
    nnue::Head<W, B> head{(const W*)l1_w, (const B*)l1_b, (const W*)l2_w,
                          (const B*)l2_b, (const W*)out_w, (const B*)out_b,
                          nnue::L1, nnue::H1, nnue::H2};
    int grid = (batch + LANES - 1) / LANES;
    forward_kernel<A, W, B><<<grid, LANES * WARP, 0, (cudaStream_t)stream>>>(
        (const A*)acc, (const int32_t*)stm, (const int32_t*)bucket, head, (float*)out, batch);
    return (int)cudaGetLastError();
}

}  // namespace

// acc (batch, 2, 64), stm/bucket (batch,) int32; weights of the shipped
// net's shape: l1_w (8, 128, 16), l1_b (8, 16), l2_w (8, 16, 32),
// l2_b (8, 32), out_w (8, 32), out_b (8,) → out (batch,) f32
FISHNET_EXPORT int nnue_forward_from_acc_f32(
        const void* acc, const void* stm, const void* bucket, const void* l1_w,
        const void* l1_b, const void* l2_w, const void* l2_b, const void* out_w,
        const void* out_b, void* out, int batch, void* stream) {
    return launch<float, float, float>(acc, stm, bucket, l1_w, l1_b, l2_w, l2_b, out_w,
                                       out_b, out, batch, stream);
}

FISHNET_EXPORT int nnue_forward_from_acc_i8(
        const void* acc, const void* stm, const void* bucket, const void* l1_w,
        const void* l1_b, const void* l2_w, const void* l2_b, const void* out_w,
        const void* out_b, void* out, int batch, void* stream) {
    return launch<int32_t, int8_t, int32_t>(acc, stm, bucket, l1_w, l1_b, l2_w, l2_b, out_w,
                                            out_b, out, batch, stream);
}

// acc (batch, 2, 64) f32; the weights and biases bf16, the shapes as above
FISHNET_EXPORT int nnue_forward_from_acc_bf16(
        const void* acc, const void* stm, const void* bucket, const void* l1_w,
        const void* l1_b, const void* l2_w, const void* l2_b, const void* out_w,
        const void* out_b, void* out, int batch, void* stream) {
    return launch<float, __nv_bfloat16, __nv_bfloat16>(acc, stm, bucket, l1_w, l1_b, l2_w,
                                                       l2_b, out_w, out_b, out, batch, stream);
}
