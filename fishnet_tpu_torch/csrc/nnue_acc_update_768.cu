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
// perspective) rows. Each thread recomputes the row's <= 4 (feature,
// sign) pairs (cheap integer work, no shared memory needed), merges equal
// features into one signed weight (a chess960 castle can move a piece
// onto its own square: +1 and -1 cancel, as the reference's weight vector
// does), and adds the rows in the order XLA:CPU reduces the reference's
// 768-long contraction (measured bit-exact): increasing feature index,
// rows of one 32-row block summed in order, block sums added in order;
// only then is the delta added to the parent. Integer accumulators are
// exact in any order.
#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 4;
constexpr int SLOTS = 4;
constexpr int NONE = 1 << 20;

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
    int persp = row & 1;
    int idx[SLOTS], w[SLOTS];
    for (int i = 0; i < SLOTS; ++i) {
        int code = codes[lane * SLOTS + i];
        idx[i] = code > 0 ? feature_768(code, sqs[lane * SLOTS + i], persp) : NONE;
        w[i] = signs[lane * SLOTS + i];
    }
    for (int i = 1; i < SLOTS; ++i) {  // merge repeated features
        for (int j = 0; j < i; ++j) {
            if (idx[i] != NONE && idx[j] == idx[i]) {
                w[j] += w[i];
                idx[i] = NONE;
            }
        }
    }
    for (int i = 1; i < SLOTS; ++i) {  // insertion sort by feature index
        int ki = idx[i], wi = w[i], j = i - 1;
        while (j >= 0 && idx[j] > ki) {
            idx[j + 1] = idx[j];
            w[j + 1] = w[j];
            --j;
        }
        idx[j + 1] = ki;
        w[j + 1] = wi;
    }
    A total = 0, block = 0;
    int cur = -1;
    for (int i = 0; i < SLOTS && idx[i] != NONE; ++i) {
        if ((idx[i] >> 5) != cur) {
            total = total + block;
            block = 0;
            cur = idx[i] >> 5;
        }
        block = block + (A)ft_w[(int64_t)idx[i] * l1 + col] * (A)w[i];
    }
    total = total + block;
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
