// K15 nnue_ft_backward_768: the backward pass through the board768 feature
// transform of a training batch. ft_w's gradient row r collects, for every
// sample and perspective whose board has the piece of feature r on its
// square, that perspective's accumulator gradient d_acc[b, p, :]; ft_b's
// gradient is d_acc summed over samples and both perspectives.
//
// Replaces: the feature transform's part of jax.value_and_grad(loss_fn)
// inside fishnet_tpu/models/train.py:47 make_train_step and :69
// make_sharded_train_step (the gradient of models/nnue.py:160
// accumulators_768 and :151 refresh_accumulator_768: a scatter-add of d_acc
// into the gathered rows; the masked clip(idx, 0) row of an empty square
// gets zeros).
//
// Bound on the H100: bytes. At B = 512 and L1 64 it reads d_acc (256 KiB)
// and the boards (128 KiB) and writes 769 x 64 floats (197 KiB): ~0.18 us
// of HBM time. Latency sets the time instead: each column's ordered chain
// of adds (2B for ft_b, up to 2B for a row every pair shares) and the
// round trips between the passes.
//
// Design: ft_backward.cuh's ordered inverse index (mark, rows, sums, ft_b)
// over the 768 board768 rows: each row costs what the batch puts in it,
// where a gather over the batch (a thread a column walking every sample)
// pays a dependent round trip a sample.
#include "ft_backward.cuh"

// d_acc (batch, 2, l1) f32, boards (batch, 64) int32 → grad (769, l1) f32:
// ft_w's gradient (768 rows), then ft_b's; scratch: zero (and left zero
// after stages 7), ft_backward.cuh's layout; batch >= 1, l1 >= 1. stages:
// 7 the gradient, else its passes (ft_backward.cuh ft_backward).
FISHNET_EXPORT int nnue_ft_backward_768(const void* d_acc, const void* boards, void* grad,
                                        void* scratch, int batch, int l1, int stages,
                                        void* stream) {
    return ftb::ft_backward<ftb::Board768>((const float*)d_acc, (const int32_t*)boards,
                                           (float*)grad, (unsigned*)scratch, batch, l1, stages,
                                           (cudaStream_t)stream);
}
