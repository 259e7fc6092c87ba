// K3 nnue_acc_update_768: the child's accumulator pair from the parent's,
// child = parent + signed sum of the <= 4 feature rows a move changes, per
// perspective.
//
// Replaces: fishnet_tpu/models/nnue.py:169 apply_acc_updates_768 (called
// every search step at fishnet_tpu/ops/search.py:810).
//
// Bound on the H100: bytes. Per lane it reads the parent pair (2 x 64 x 4
// B), the 4 change slots (48 B) and at most 8 ft_w rows, which come from
// L2 (the table is 192 KiB), and writes the child pair (512 B): about 1 KB
// a lane, so ~0.3 us of HBM time at B = 1024 — far below launch overhead.
//
// Design: one thread per accumulator column, a block holds 4 (lane,
// perspective) rows. Each thread computes the row's delta with nnue.cuh
// acc_delta (the body the segment kernel K11 calls too): the <= 4
// (feature, sign) pairs recomputed per thread (cheap integer work, no
// shared memory), equal features merged, rows added in XLA:CPU's order
// (measured bit-exact); only then is the delta added to the parent.
// Integer accumulators are exact in any order. A bf16 net's rows are read
// as bf16 (2 B a column, one scalar load each: no wider load whose
// alignment could change) and widened at the load, the sums f32 in the
// same order, so its accumulators are the f32 kernel's bits on the
// widened rows.
#include "nnue.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 4;

template <typename W, typename A>
__global__ void update_kernel(const A* __restrict__ acc_in,
                              const int32_t* __restrict__ codes,
                              const int32_t* __restrict__ sqs,
                              const int32_t* __restrict__ signs,
                              const W* __restrict__ ft_w,
                              A* __restrict__ acc_out, int n_rows, int l1) {
    int col = threadIdx.x;
    int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.y;
    if (row >= n_rows || col >= l1) return;
    int lane = row >> 1;
    int s = lane * nnue::SLOTS;
    A total = nnue::acc_delta<W, A>(codes + s, sqs + s, signs + s, row & 1, col, ft_w, l1);
    int64_t o = (int64_t)row * l1 + col;
    acc_out[o] = acc_in[o] + total;
}

template <typename W, typename A>
int launch(const void* acc_in, const void* codes, const void* sqs,
           const void* signs, const void* ft_w, void* acc_out, int batch,
           int l1, void* stream) {
    int n_rows = batch * 2;
    dim3 block(l1, ROWS_PER_BLOCK);
    dim3 grid((n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    update_kernel<W, A><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const A*)acc_in, (const int32_t*)codes, (const int32_t*)sqs,
        (const int32_t*)signs, (const W*)ft_w, (A*)acc_out, n_rows, l1);
    return (int)cudaGetLastError();
}

}  // namespace

FISHNET_EXPORT int nnue_acc_update_768_f32(const void* acc_in, const void* codes,
                                           const void* sqs, const void* signs,
                                           const void* ft_w, void* acc_out,
                                           int batch, int l1, void* stream) {
    return launch<float, float>(acc_in, codes, sqs, signs, ft_w, acc_out,
                                batch, l1, stream);
}

FISHNET_EXPORT int nnue_acc_update_768_i16(const void* acc_in, const void* codes,
                                           const void* sqs, const void* signs,
                                           const void* ft_w, void* acc_out,
                                           int batch, int l1, void* stream) {
    return launch<int16_t, int32_t>(acc_in, codes, sqs, signs, ft_w, acc_out,
                                    batch, l1, stream);
}

// bf16 net: ft_w (768, l1) bf16, acc f32
FISHNET_EXPORT int nnue_acc_update_768_bf16(const void* acc_in, const void* codes,
                                            const void* sqs, const void* signs,
                                            const void* ft_w, void* acc_out,
                                            int batch, int l1, void* stream) {
    return launch<__nv_bfloat16, float>(acc_in, codes, sqs, signs, ft_w, acc_out,
                                        batch, l1, stream);
}
