// K13 nnue_evaluate_sf: the full evaluation of an imported Stockfish
// HalfKAv2_hm net (models/nnue_import.py StockfishNet, dequantized f32):
// both perspectives' feature transform and PSQT sums from the board, the
// pairwise clipped product (side to move first), the output bucket's fc0
// (16 x L1, row 15 the skip), the squared-clipped fc1 (32 x 30), fc2
// (1 x 32), plus half the PSQT difference, x NNUE2SCORE.
//
// Replaces: fishnet_tpu/models/nnue_import.py:298 evaluate_sf, the leaf
// eval of the search on such a net (fishnet_tpu/ops/search.py:444-445 via
// models/nnue.py:324 evaluate).
//
// Bound on the H100: bytes, from HBM. At L1 3072 the feature transform is
// 22,528 x 3,072 x 4 B = 277 MB, far past the 50 MB L2: a lane reads its
// pieces' rows (up to 2 x 32 x 12 KiB = 0.79 MB), the bucket's fc0 rows
// (16 x 3,072 x 4 B = 192 KiB, shared by the lanes of a bucket), one PSQT
// word a piece, and writes 4 B. About 0.25 us of HBM time a lane.
//
// Design: one warp per lane, four lanes a block; the body is nnue.cuh
// evaluate_sf_warp, which the segment kernel (K11) calls too. The warp
// compacts the pieces' feature rows into a list in shared memory, then
// each thread streams the column pairs (c, c + L1/2), c = t, t + 32, ...
// of both perspectives: the rows' words at c are read by the 32 threads
// together (coalesced), summed in the reference's order, paired, clipped
// and multiplied, and folded straight into the thread's 16 fc0 partial
// sums, so no (2, L1) accumulator is kept. Warp sums finish fc0; thread j
// runs fc1 unit j and its fc2 term. The layer stack sums in another order
// than the plain version's matmuls: the eval is held to it within a
// stated tolerance.
#include "nnue.cuh"

namespace {

constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32)
evaluate_sf_kernel(const int32_t* __restrict__ boards, int64_t sb,
                   const int32_t* __restrict__ stm, int64_t ss, nnue::SfNet net,
                   float* __restrict__ out, int batch) {
    __shared__ nnue::Features feats[WARPS];
    const int w = threadIdx.x / 32, t = threadIdx.x % 32;
    const int lane = blockIdx.x * WARPS + w;
    if (lane >= batch) return;  // the whole warp
    nnue::Features& f = feats[w];
    nnue::features_warp(boards + lane * sb, t, f);
    const float ev = nnue::evaluate_sf_warp(f, stm[lane * ss], nnue::output_bucket(f), net, t);
    if (t == 0) out[lane] = ev;
}

}  // namespace

// boards (batch, 64) int32 rows sb elements apart, stm (batch,) ss apart;
// the net (f32): ft_w (22528, l1), ft_b (l1,), psqt_w (22528, 8), fc0_w
// (8, 16, l1), fc0_b (8, 16), fc1_w (8, 32, 30), fc1_b (8, 32), fc2_w
// (8, 1, 32), fc2_b (8, 1); l1 even → out (batch,) f32
FISHNET_EXPORT int nnue_evaluate_sf(const void* boards, int64_t sb, const void* stm, int64_t ss,
                                    const void* ft_w, const void* ft_b, const void* psqt_w,
                                    const void* fc0_w, const void* fc0_b, const void* fc1_w,
                                    const void* fc1_b, const void* fc2_w, const void* fc2_b,
                                    void* out, int batch, int l1, void* stream) {
    if (l1 <= 0 || l1 % 2) return (int)cudaErrorInvalidValue;
    nnue::SfNet net{(const float*)ft_w,  (const float*)ft_b,  (const float*)psqt_w,
                    (const float*)fc0_w, (const float*)fc0_b, (const float*)fc1_w,
                    (const float*)fc1_b, (const float*)fc2_w, (const float*)fc2_b, l1};
    const int grid = (batch + WARPS - 1) / WARPS;
    evaluate_sf_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)boards, sb, (const int32_t*)stm, ss, net, (float*)out, batch);
    return (int)cudaGetLastError();
}
