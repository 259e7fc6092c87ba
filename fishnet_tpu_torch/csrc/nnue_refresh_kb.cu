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
// What holds it back is latency: a sample's ~30 rows a column are a chain
// of dependent adds, each row a load from L2.
//
// Design: a warp a sample, a block a sample (WARPS: one-warp blocks
// spread a 512-sample batch over all 132 SMs; 1, 2, 4 and 8 samples a
// block timed within 6% of each other on the H100). nnue.cuh features_warp lists each perspective's feature rows in
// square order (ballots over the 64 squares), then the warp's threads
// take the (perspective, column) items of both perspectives together:
// where L1 is a multiple of 4 and ft_w, ft_b and acc are 16-byte aligned
// an item is four neighbouring columns read with one 16-byte load a row
// (at L1 64 half a warp a perspective), else one column (any L1 up to
// MAX_L1, a tp shard's block at any width or offset). nnue.cuh row_sums
// reads a group of row indices into registers and issues the group's
// loads before the adds of the group before it, and adds in the old
// order: squares 0-31 and 32-63 each in order, the halves added, ft_b
// last, K1's order and the plain version's (models/nnue.py accumulators,
// sum_rows), so the two agree bit for bit. Each column is summed on its
// own, so a tp shard's columns (a contiguous (22528, L1 / tp) block) give
// the full net's bits.
#include "nnue.cuh"

namespace {

constexpr int WARPS = 1;  // samples a block
constexpr int GROUP = 8;  // rows whose loads go out together

template <class T>
__global__ void __launch_bounds__(WARPS * 32)
refresh_kb_kernel(const int32_t* __restrict__ boards, const float* __restrict__ ft_w,
                  const float* __restrict__ ft_b, float* __restrict__ acc, int batch, int l1) {
    __shared__ nnue::Features feats[WARPS];
    constexpr int V = sizeof(T) / sizeof(float);
    const int w = threadIdx.x / 32, t = threadIdx.x % 32;
    const int lane = blockIdx.x * WARPS + w;
    if (lane >= batch) return;  // the whole warp
    nnue::Features& f = feats[w];
    nnue::features_warp(boards + (int64_t)lane * 64, t, f);
    const int vl = l1 / V;  // vectors a row
    const T* rows = reinterpret_cast<const T*>(ft_w);
    const T* bias = reinterpret_cast<const T*>(ft_b);
    for (int j = t; j < 2 * vl; j += 32) {
        const int p = j / vl, v = j - p * vl;
        const T* const col[1] = {rows + v};
        T sum[1];
        nnue::row_sums<1, GROUP>(f.idx[p], f.lo[p], f.n[p], col, vl, sum);
        reinterpret_cast<T*>(acc + ((int64_t)lane * 2 + p) * l1)[v] =
            nnue::vadd(__ldg(bias + v), sum[0]);
    }
}

}  // namespace

// boards (batch, 64) int32; ft_w (22528, l1) f32, ft_b (l1,) f32 →
// acc (batch, 2, l1) f32
FISHNET_EXPORT int nnue_refresh_kb(const void* boards, const void* ft_w, const void* ft_b,
                                   void* acc, int batch, int l1, void* stream) {
    if (batch <= 0 || l1 <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const bool vec = l1 % 4 == 0 && ((uintptr_t)ft_w | (uintptr_t)ft_b | (uintptr_t)acc) % 16 == 0;
    const int grid = (batch + WARPS - 1) / WARPS;
    if (vec) {
        refresh_kb_kernel<float4><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            (const int32_t*)boards, (const float*)ft_w, (const float*)ft_b, (float*)acc, batch,
            l1);
    } else {
        refresh_kb_kernel<float><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            (const int32_t*)boards, (const float*)ft_w, (const float*)ft_b, (float*)acc, batch,
            l1);
    }
    return (int)cudaGetLastError();
}
