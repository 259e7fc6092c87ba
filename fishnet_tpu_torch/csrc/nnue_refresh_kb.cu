// K17 nnue_refresh_kb: both perspectives' HalfKAv2_hm accumulators of a
// king-bucketed net from scratch, kept for the trainer's backward:
// acc[b, p, :] = ft_b + the sum of the ft_w rows of the pieces of board b
// seen from perspective p (its king bucket, black's view rank-flipped,
// files mirrored so that the king sits on files a-d).
//
// Replaces: fishnet_tpu/models/nnue.py:127 accumulators (with :117
// refresh_accumulator and :93 feature_indices), which
// fishnet_tpu/models/train.py:27 batched_forward runs on a king-bucketed
// net inside make_train_step (:47) and make_sharded_train_step (:69), the
// latter on each tp shard's columns of ft_w.
//
// Bound on the H100: bytes. A sample reads its board (256 B) and, for
// each perspective, the rows of its <= 32 pieces (L1 x 4 B each); the
// table is 22,528 x L1 f32 (5.8 MB at L1 64), so the rows a batch shares
// stay in L2 and what the card must move is the boards, the distinct rows
// the batch selects once, and the accumulators out (B x 2 x L1 x 4 B).
//
// Design: K12's refresh with its accumulators written out. One warp per
// sample, four samples a block: nnue.cuh features_warp lists each
// perspective's feature rows in square order (ballots over the 64
// squares), then each thread sums the columns c = t, t + 32, ... with
// refresh_column (squares 0-31 and 32-63 each summed in order, the halves
// added) and adds ft_b last: K1's order and the plain version's
// (models/nnue.py accumulators, sum_rows), so the two agree bit for bit.
// Each column is summed on its own, so a tp shard's columns (a contiguous
// (22528, L1 / tp) block) give the full net's bits. L1 is a run-time
// argument; a thread reads one float a column, so no width needs
// alignment.
#include "nnue.cuh"

namespace {

constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32)
refresh_kb_kernel(const int32_t* __restrict__ boards, const float* __restrict__ ft_w,
                  const float* __restrict__ ft_b, float* __restrict__ acc, int batch, int l1) {
    __shared__ nnue::Features feats[WARPS];
    const int w = threadIdx.x / 32, t = threadIdx.x % 32;
    const int lane = blockIdx.x * WARPS + w;
    if (lane >= batch) return;  // the whole warp
    nnue::Features& f = feats[w];
    nnue::features_warp(boards + (int64_t)lane * 64, t, f);
    for (int p = 0; p < 2; ++p) {
        float* out = acc + ((int64_t)lane * 2 + p) * l1;
        for (int c = t; c < l1; c += 32) {
            out[c] = ft_b[c] + nnue::refresh_column<float, float>(f, p, ft_w, l1, c);
        }
    }
}

}  // namespace

// boards (batch, 64) int32; ft_w (22528, l1) f32, ft_b (l1,) f32 →
// acc (batch, 2, l1) f32
FISHNET_EXPORT int nnue_refresh_kb(const void* boards, const void* ft_w, const void* ft_b,
                                   void* acc, int batch, int l1, void* stream) {
    if (batch <= 0 || l1 <= 0) return (int)cudaErrorInvalidValue;
    const int grid = (batch + WARPS - 1) / WARPS;
    refresh_kb_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)boards, (const float*)ft_w, (const float*)ft_b, (float*)acc, batch, l1);
    return (int)cudaGetLastError();
}
