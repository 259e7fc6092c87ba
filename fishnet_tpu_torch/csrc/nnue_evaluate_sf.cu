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
// word a piece, and writes 4 B. About 0.25 us of HBM time a lane. A
// batch's lanes share many rows (the kings' and the pawns' home squares),
// so most of the rows a batch reads hit the L2 once another lane has
// brought them in.
//
// Design: the eval in units (nnue.cuh sf_ft_unit, sf_fc0_unit,
// sf_finish), which K11 spreads over its waiting warps; here three
// launches run them across the batch, a warp a unit: (1) every lane's
// feature-transform units, (lane, perspective, column slice), each warp
// listing its board's feature rows (features_warp) and streaming its
// slice's rows with 16-byte loads, a group of rows in flight, into the
// lane's products in the scratch buffer; (2) every lane's 16 fc0 units,
// a warp an fc0 row, thread t chain (row, t); (3) a warp a lane closes
// the chains with warp sums and runs fc1, fc2 and the PSQT sums. The
// units are K11's, so the plain search step on the card (which launches
// this kernel) gives K11's bits. The layer stack sums in another order
// than the plain version's matmuls: the eval is held to it within a
// stated tolerance.
#include "nnue.cuh"

namespace {

constexpr int WARPS = 4;

__device__ __forceinline__ int lane_bucket(const int32_t* board, int t) {
    const int n = __popc(__ballot_sync(nnue::FULL, board[t] > 0))
                  + __popc(__ballot_sync(nnue::FULL, board[t + 32] > 0));
    return min(max((n - 1) / 4, 0), 7);
}

__global__ void __launch_bounds__(WARPS * 32)
ft_kernel(const int32_t* __restrict__ boards, int64_t sb, const int32_t* __restrict__ stm,
          int64_t ss, nnue::SfNet net, float* __restrict__ buf, int batch, int units) {
    __shared__ nnue::Features feats[WARPS];
    const int w = threadIdx.x / 32, t = threadIdx.x % 32;
    const int64_t g = (int64_t)blockIdx.x * WARPS + w;
    const int lane = (int)(g / units), u = (int)(g % units);
    if (lane >= batch) return;  // the whole warp
    nnue::Features& f = feats[w];
    nnue::features_warp(boards + lane * sb, t, f);
    nnue::sf_ft_unit(f, stm[lane * ss], u, net, buf + (int64_t)lane * nnue::sf_buffer_floats(net.l1),
                     t);
}

__global__ void __launch_bounds__(WARPS * 32)
fc0_kernel(const int32_t* __restrict__ boards, int64_t sb, nnue::SfNet net,
           float* __restrict__ buf, int batch) {
    const int w = threadIdx.x / 32, t = threadIdx.x % 32;
    const int64_t g = (int64_t)blockIdx.x * WARPS + w;
    const int lane = (int)(g / nnue::SF_FC0_UNITS), i = (int)(g % nnue::SF_FC0_UNITS);
    if (lane >= batch) return;
    float* x = buf + (int64_t)lane * nnue::sf_buffer_floats(net.l1);
    nnue::sf_fc0_unit(lane_bucket(boards + lane * sb, t), i, net, x,
                      x + nnue::sf_x_stride(net.l1), t);
}

__global__ void __launch_bounds__(WARPS * 32)
finish_kernel(const int32_t* __restrict__ boards, int64_t sb, const int32_t* __restrict__ stm,
              int64_t ss, nnue::SfNet net, const float* __restrict__ buf,
              float* __restrict__ out, int batch) {
    __shared__ nnue::Features feats[WARPS];
    const int w = threadIdx.x / 32, t = threadIdx.x % 32;
    const int lane = blockIdx.x * WARPS + w;
    if (lane >= batch) return;
    nnue::Features& f = feats[w];
    nnue::features_warp(boards + lane * sb, t, f);
    const float* x = buf + (int64_t)lane * nnue::sf_buffer_floats(net.l1);
    const float ev = nnue::sf_finish(f, stm[lane * ss], nnue::output_bucket(f), net,
                                     x + nnue::sf_x_stride(net.l1), t);
    if (t == 0) out[lane] = ev;
}

int blocks(int64_t warps) { return (int)((warps + WARPS - 1) / WARPS); }

}  // namespace

// boards (batch, 64) int32 rows sb elements apart, stm (batch,) ss apart;
// the net (f32): ft_w (22528, l1), ft_b (l1,), psqt_w (22528, 8), fc0_w
// (8, 16, l1), fc0_b (8, 16), fc1_w (8, 32, 30), fc1_b (8, 32), fc2_w
// (8, 1, 32), fc2_b (8, 1); l1 even; buf (batch, sf_buffer_floats(l1))
// f32 scratch → out (batch,) f32
FISHNET_EXPORT int nnue_evaluate_sf(const void* boards, int64_t sb, const void* stm, int64_t ss,
                                    const void* ft_w, const void* ft_b, const void* psqt_w,
                                    const void* fc0_w, const void* fc0_b, const void* fc1_w,
                                    const void* fc1_b, const void* fc2_w, const void* fc2_b,
                                    void* buf, void* out, int batch, int l1, void* stream) {
    if (l1 <= 0 || l1 % 2 || batch <= 0) return (int)cudaErrorInvalidValue;
    nnue::SfNet net{(const float*)ft_w,  (const float*)ft_b,  (const float*)psqt_w,
                    (const float*)fc0_w, (const float*)fc0_b, (const float*)fc1_w,
                    (const float*)fc1_b, (const float*)fc2_w, (const float*)fc2_b, l1,
                    nnue::sf_vec_ok((const float*)ft_w, (const float*)ft_b, l1)};
    const cudaStream_t s = (cudaStream_t)stream;
    const int32_t* b = (const int32_t*)boards;
    const int32_t* m = (const int32_t*)stm;
    float* x = (float*)buf;
    const int units = nnue::sf_ft_units(net);
    ft_kernel<<<blocks((int64_t)batch * units), WARPS * 32, 0, s>>>(b, sb, m, ss, net, x, batch,
                                                                    units);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fc0_kernel<<<blocks((int64_t)batch * nnue::SF_FC0_UNITS), WARPS * 32, 0, s>>>(b, sb, net, x,
                                                                                 batch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    finish_kernel<<<blocks(batch), WARPS * 32, 0, s>>>(b, sb, m, ss, net, x, (float*)out, batch);
    return (int)cudaGetLastError();
}
