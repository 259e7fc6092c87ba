// K1 nnue_refresh_768: both perspectives' board768 accumulators from
// scratch, acc[b, p, :] = ft_b + sum of the ft_w rows of the pieces.
//
// Replaces: fishnet_tpu/models/nnue.py:160 accumulators_768 (called per
// root at fishnet_tpu/ops/search.py:262, init_state).
//
// Bound on the H100: bytes. Each output column reads at most 32 rows of
// ft_w (64 x 4 B), but the whole 768 x 64 table is 192 KiB, so after the
// first lanes it sits in L2 and what the card must move is the boards
// (B x 256 B) in and the accumulators (B x 512 B) out: one launch per
// dispatch, microseconds at B = 1024 either way.
//
// Design: one thread per accumulator column, a block holds 4 (lane,
// perspective) rows x 64 columns = 256 threads. Every thread of a row
// reads the same board square (a broadcast load) and the 64 threads of a
// row read one ft_w row together (coalesced). The float order is the one
// the JAX reference's XLA:CPU reduction uses (measured bit-exact): squares
// 0-31 summed in order, squares 32-63 summed in order, the two halves
// added, then ft_b added. Integer (int8-net) accumulators are exact in any
// order. A bf16 net (models/nnue.py cast_params) reads bf16 rows and bias
// (half the bytes: its table is 96 KiB) and widens each value as it loads
// it (nnue::wide), then adds in f32 in the same order, so its accumulators
// are the f32 kernel's bits on the widened weights.
#include "nnue.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 4;

template <typename W, typename Bi, typename A>
__global__ void refresh_kernel(const int32_t* __restrict__ boards,
                               const W* __restrict__ ft_w,
                               const Bi* __restrict__ ft_b,
                               A* __restrict__ acc, int n_rows, int l1) {
    int col = threadIdx.x;
    int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.y;  // lane * 2 + persp
    if (row >= n_rows || col >= l1) return;
    int lane = row >> 1;
    int persp = row & 1;
    const int32_t* board = boards + (int64_t)lane * 64;
    A half[2];
    for (int h = 0; h < 2; ++h) {
        A s = 0;
        for (int sq = h * 32; sq < h * 32 + 32; ++sq) {
            int code = board[sq];
            if (code <= 0) continue;
            s = s + (A)nnue::wide(ft_w[(int64_t)feature_768(code, sq, persp) * l1 + col]);
        }
        half[h] = s;
    }
    acc[(int64_t)row * l1 + col] = (A)nnue::wide(ft_b[col]) + (half[0] + half[1]);
}

template <typename W, typename Bi, typename A>
int launch(const void* boards, const void* ft_w, const void* ft_b, void* acc,
           int batch, int l1, void* stream) {
    int n_rows = batch * 2;
    dim3 block(l1, ROWS_PER_BLOCK);
    dim3 grid((n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    refresh_kernel<W, Bi, A><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)boards, (const W*)ft_w, (const Bi*)ft_b, (A*)acc,
        n_rows, l1);
    return (int)cudaGetLastError();
}

}  // namespace

// f32 net: ft_w (768, l1) f32, ft_b (l1,) f32 → acc (batch, 2, l1) f32
FISHNET_EXPORT int nnue_refresh_768_f32(const void* boards, const void* ft_w,
                                        const void* ft_b, void* acc, int batch,
                                        int l1, void* stream) {
    return launch<float, float, float>(boards, ft_w, ft_b, acc, batch, l1, stream);
}

// int8 net: ft_w (768, l1) int16, ft_b (l1,) int32 → acc int32
FISHNET_EXPORT int nnue_refresh_768_i16(const void* boards, const void* ft_w,
                                        const void* ft_b, void* acc, int batch,
                                        int l1, void* stream) {
    return launch<int16_t, int32_t, int32_t>(boards, ft_w, ft_b, acc, batch, l1, stream);
}

// bf16 net: ft_w (768, l1) bf16, ft_b (l1,) bf16 → acc (batch, 2, l1) f32
FISHNET_EXPORT int nnue_refresh_768_bf16(const void* boards, const void* ft_w,
                                         const void* ft_b, void* acc, int batch,
                                         int l1, void* stream) {
    return launch<__nv_bfloat16, __nv_bfloat16, float>(boards, ft_w, ft_b, acc, batch, l1,
                                                       stream);
}
