// K15 nnue_ft_backward_768: the backward pass through the board768 feature
// transform of a training batch. ft_w's gradient row r collects, for every
// sample and perspective whose board has the piece of feature r on its
// square, that perspective's accumulator gradient d_acc[b, p, :]; ft_b's
// gradient is d_acc summed over samples and both perspectives.
//
// Replaces: the feature transform's part of jax.value_and_grad(loss_fn)
// inside fishnet_tpu/models/train.py:47 make_train_step (the gradient of
// models/nnue.py:160 accumulators_768 and :151 refresh_accumulator_768: a
// scatter-add of d_acc into the gathered rows; the masked clip(idx, 0) row
// of an empty square gets zeros).
//
// Bound on the H100: bytes. At B = 512 it reads d_acc (256 KiB) and the
// boards (128 KiB) and writes 769 x 64 floats (197 KiB): ~0.17 us of HBM
// time; its 2 x 768 x 64 x 512 = 50 M compares are integer work, and the
// per-thread walk over the batch, not bytes, sets its time.
//
// Design: gather form, no scatter and no float atomics (two launches on
// the same inputs give the same bytes). A block owns one row of the
// gradient (768 feature rows, then ft_b), a thread one column of it. A
// feature row is one (piece code, square) per perspective: row kind * 64 +
// o_sq is the piece of kind `kind` on o_sq seen from white, and on o_sq ^ 56
// seen from black (models/nnue.py feature_index_768: own pieces are kinds
// 0-5). The thread walks the batch in index order, white's perspective
// before black's in each sample, and adds d_acc[b, p, col] wherever
// boards[b, sq_p] is that code. Every thread of a block reads the same
// board word (a broadcast) and the block reads one d_acc row together.
#include "common.cuh"

namespace {

constexpr int FEATURES = 768;

__global__ void ft_backward_kernel(const float* __restrict__ d_acc,
                                   const int32_t* __restrict__ boards,
                                   float* __restrict__ grad, int batch, int l1) {
    int row = blockIdx.x;
    int col = threadIdx.x;
    if (col >= l1) return;
    float sum = 0.0f;
    if (row < FEATURES) {
        int kind = row >> 6, o_sq = row & 63;
        // the code white's view sees as this kind on o_sq, and black's on o_sq ^ 56
        int code_w = 1 + kind;
        int code_b = kind < 6 ? 7 + kind : kind - 5;
        int sq_w = o_sq, sq_b = o_sq ^ 56;
        for (int b = 0; b < batch; ++b) {
            const int32_t* board = boards + (int64_t)b * 64;
            const float* d = d_acc + (int64_t)b * 2 * l1 + col;
            if (board[sq_w] == code_w) sum = __fadd_rn(sum, d[0]);
            if (board[sq_b] == code_b) sum = __fadd_rn(sum, d[l1]);
        }
    } else {  // ft_b
        for (int b = 0; b < batch; ++b) {
            const float* d = d_acc + (int64_t)b * 2 * l1 + col;
            sum = __fadd_rn(__fadd_rn(sum, d[0]), d[l1]);
        }
    }
    grad[(int64_t)row * l1 + col] = sum;
}

}  // namespace

// d_acc (batch, 2, l1) f32, boards (batch, 64) int32 → grad (769, l1) f32:
// ft_w's gradient (768 rows), then ft_b's; l1 <= 1024 (a block's threads)
FISHNET_EXPORT int nnue_ft_backward_768(const void* d_acc, const void* boards, void* grad,
                                        int batch, int l1, void* stream) {
    ft_backward_kernel<<<FEATURES + 1, l1, 0, (cudaStream_t)stream>>>(
        (const float*)d_acc, (const int32_t*)boards, (float*)grad, batch, l1);
    return (int)cudaGetLastError();
}
