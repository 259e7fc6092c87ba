// K12 nnue_evaluate: the full evaluation of a king-bucketed (HalfKAv2_hm,
// 22,528 features a perspective) NnueParams net: both perspectives'
// accumulators refreshed from the board, then the output bucket's
// 2*L1 -> H1 -> H2 -> 1 layer stack, x600 (the int8 net: the fixed-point
// ladder, exact integer arithmetic).
//
// Replaces: fishnet_tpu/models/nnue.py:324 evaluate on such a net, with
// :127 accumulators, :117 refresh_accumulator, :93 feature_indices and
// :299 forward_from_acc; the search's leaf eval of every net that is not
// board768 (fishnet_tpu/ops/search.py:444-445).
//
// Bound on the H100: bytes. A lane reads its board (256 B) and, for each
// perspective, the rows of its <= 32 pieces (L1 x 4 B each, f32; 2 B on
// the int8 net), plus the bucket's first-layer weights (2*L1 x H1) once
// per distinct bucket; at L1 256 that is up to 64 KiB of rows a lane, and
// the 22,528-row table (23 MB f32) does not stay in L2 across a batch of
// positions that share few pieces-and-king-buckets.
//
// Design: one warp per lane, four lanes a block; the body is nnue.cuh
// evaluate_warp, which the segment kernel (K11) calls too. The warp
// compacts the pieces' feature rows into a list in shared memory (ballots
// over the 64 squares, square order kept), then each thread streams the
// columns c = t, t + 32, ...: the rows' values at c are read by the 32
// threads together (coalesced), summed in the reference's order (so the
// accumulators are the plain version's bit for bit), clipped and folded
// straight into the thread's partial first-layer sums; a warp sum a unit,
// one second-layer unit a thread, a warp sum for the output. The f32
// layer stack sums in another order than the plain version's matmul: its
// eval is held to it within a stated tolerance, the int8 eval exactly.
// A bf16 net (models/nnue.py cast_params) reads half the f32 rows' bytes
// (2 B a column) and widens each value at its load; the sums are f32 in
// the f32 body's order, so its eval is the f32 kernel's bits on the
// widened weights. Each thread loads one column of a row at a time, so
// no load is wider than the type and an even L1 keeps the rows aligned.
#include "nnue.cuh"

namespace {

constexpr int WARPS = 4;

template <typename F, typename W, typename B>
__global__ void __launch_bounds__(WARPS * 32)
evaluate_kernel(const int32_t* __restrict__ boards, int64_t sb, const int32_t* __restrict__ stm,
                int64_t ss, nnue::Net<F, W, B> net, float* __restrict__ out, int batch) {
    __shared__ nnue::Features feats[WARPS];
    const int w = threadIdx.x / 32, t = threadIdx.x % 32;
    const int lane = blockIdx.x * WARPS + w;
    if (lane >= batch) return;  // the whole warp
    nnue::Features& f = feats[w];
    nnue::features_warp(boards + lane * sb, t, f);
    const float ev = nnue::evaluate_warp(f, stm[lane * ss], nnue::output_bucket(f), net, t);
    if (t == 0) out[lane] = ev;
}

template <typename F, typename W, typename B>
int launch(const void* boards, int64_t sb, const void* stm, int64_t ss, const void* ft_w,
           const void* ft_b, const void* l1_w, const void* l1_b, const void* l2_w,
           const void* l2_b, const void* out_w, const void* out_b, void* out, int batch, int l1,
           int h1, int h2, void* stream) {
    if (l1 <= 0 || h1 <= 0 || h1 > nnue::MAX_H || h2 <= 0 || h2 > nnue::MAX_H) {
        return (int)cudaErrorInvalidValue;
    }
    nnue::Net<F, W, B> net{(const F*)ft_w, (const B*)ft_b,
                           {(const W*)l1_w, (const B*)l1_b, (const W*)l2_w, (const B*)l2_b,
                            (const W*)out_w, (const B*)out_b, l1, h1, h2}};
    const int grid = (batch + WARPS - 1) / WARPS;
    evaluate_kernel<F, W, B><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)boards, sb, (const int32_t*)stm, ss, net, (float*)out, batch);
    return (int)cudaGetLastError();
}

}  // namespace

// boards (batch, 64) int32 rows sb elements apart, stm (batch,) ss apart;
// the net: ft_w (22528, l1), ft_b (l1,), l1_w (8, 2*l1, h1), l1_b (8, h1),
// l2_w (8, h1, h2), l2_b (8, h2), out_w (8, h2), out_b (8,) (f32; the
// int8 net: ft_w int16, ft_b and biases int32, weights int8) → out
// (batch,) f32
FISHNET_EXPORT int nnue_evaluate_f32(const void* boards, int64_t sb, const void* stm, int64_t ss,
                                     const void* ft_w, const void* ft_b, const void* l1_w,
                                     const void* l1_b, const void* l2_w, const void* l2_b,
                                     const void* out_w, const void* out_b, void* out, int batch,
                                     int l1, int h1, int h2, void* stream) {
    return launch<float, float, float>(boards, sb, stm, ss, ft_w, ft_b, l1_w, l1_b, l2_w, l2_b,
                                       out_w, out_b, out, batch, l1, h1, h2, stream);
}

FISHNET_EXPORT int nnue_evaluate_i8(const void* boards, int64_t sb, const void* stm, int64_t ss,
                                    const void* ft_w, const void* ft_b, const void* l1_w,
                                    const void* l1_b, const void* l2_w, const void* l2_b,
                                    const void* out_w, const void* out_b, void* out, int batch,
                                    int l1, int h1, int h2, void* stream) {
    return launch<int16_t, int8_t, int32_t>(boards, sb, stm, ss, ft_w, ft_b, l1_w, l1_b, l2_w,
                                            l2_b, out_w, out_b, out, batch, l1, h1, h2, stream);
}

FISHNET_EXPORT int nnue_evaluate_bf16(const void* boards, int64_t sb, const void* stm,
                                      int64_t ss, const void* ft_w, const void* ft_b,
                                      const void* l1_w, const void* l1_b, const void* l2_w,
                                      const void* l2_b, const void* out_w, const void* out_b,
                                      void* out, int batch, int l1, int h1, int h2,
                                      void* stream) {
    return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        boards, sb, stm, ss, ft_w, ft_b, l1_w, l1_b, l2_w, l2_b, out_w, out_b, out, batch, l1,
        h1, h2, stream);
}
