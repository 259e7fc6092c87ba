// K18 nnue_ft_backward_kb: the backward pass through a king-bucketed
// (HalfKAv2_hm) feature transform of a training batch. ft_w's gradient
// row r collects d_acc[b, p, :] of every (sample b, perspective p) whose
// board has, seen from p, the piece of feature r on its square; ft_b's
// gradient is d_acc summed over samples and both perspectives.
//
// Replaces: the feature transform's part of jax.value_and_grad(loss_fn)
// in fishnet_tpu/models/train.py:47 make_train_step and :69
// make_sharded_train_step (there on each tp shard's column block) on a
// king-bucketed net: the gradient of models/nnue.py:127 accumulators and
// :117 refresh_accumulator, a scatter-add of d_acc into the gathered rows
// (an empty square's masked clip(idx, 0) row gets zeros).
//
// Bound on the H100: bytes. At B = 512 and L1 64 it reads d_acc (256 KiB)
// and the boards (128 KiB) and writes 22,529 x 64 floats (5.8 MB): ~1.8 us
// of HBM time, nearly all of it the gradient, of which a batch touches a
// few thousand rows and the rest are zeros.
//
// Design: ft_backward.cuh's ordered inverse index (mark, rows, sums, ft_b)
// over the 22,528 rows, each (sample, perspective, square)'s row from its
// perspective's king bucket, flip and mirror (nnue.cuh feature_kind): the
// bitmap gives each row's keys in order without a count, scan or scatter,
// and the rows of many keys sum from shared memory.
#include "ft_backward.cuh"

// d_acc (batch, 2, l1) f32, boards (batch, 64) int32 → grad ((22528 + 1)
// x l1,) f32: ft_w's gradient (22,528 rows), then ft_b's; scratch: zero
// (and left zero after stages 7), ft_backward.cuh's layout; batch >= 1,
// l1 >= 1. stages: 7 the gradient, else its passes (ft_backward.cuh
// ft_backward).
FISHNET_EXPORT int nnue_ft_backward_kb(const void* d_acc, const void* boards, void* grad,
                                       void* scratch, int batch, int l1, int stages,
                                       void* stream) {
    return ftb::ft_backward<ftb::HalfKav2Hm>((const float*)d_acc, (const int32_t*)boards,
                                             (float*)grad, (unsigned*)scratch, batch, l1, stages,
                                             (cudaStream_t)stream);
}
