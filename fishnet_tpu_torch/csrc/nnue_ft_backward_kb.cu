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
// Design: the inverse index. K15's gather form (a thread per weight, each
// walking the batch) would run 22,528 x L1 threads over B x 2 pairs here;
// instead the kernel lists the batch's (feature, sample, perspective)
// triples, at most B x 2 x 32 for boards of <= 32 pieces, and buckets
// them by feature, so each row costs what the batch puts in it:
//   1. a block a sample, a thread a square: each perspective's king square
//      (the first, as models/nnue.py king_square; 0 without one) and each
//      square's feature row (nnue.cuh feature_kind, the bucket, the flip
//      and the mirror as features_warp computes them), and the rows'
//      counts by integer atomics;
//   2. one block: the counts' exclusive prefix sums, the rows' offsets;
//   3. a thread a triple: its (sample, perspective) index k = 2b + p into
//      its row's slots, at a slot an integer atomic hands out;
//   4. a warp a row: the row's keys put in ascending order (a bitmap of
//      the keys in shared memory read back in bit order: the keys of a
//      row are distinct, since a board puts one square of a perspective
//      in a row), then each thread sums the columns c = t, t + 32, ... of
//      its keys' d_acc rows in that order, loading ahead of the adds; a
//      row with no key gets zeros, and the last warp sums ft_b's gradient
//      over every k in order.
// Every sum runs in (sample, perspective) order from 0.0 (and within a
// pair there is one square a row), the order of the plain version
// (models/train.py ft_backward_kb_plain), with no float atomics: two
// launches on the same inputs give the same bytes. Each column is summed
// on its own, so a tp shard's column block gives the full net's bits.
// A row's ordering costs its warp n / 32 + B / 512 steps, and its sums n
// dependent adds a column: a row that half the batch shares (a king on
// its home square) and the ft_b row (2B adds a column) set the time.
#include "nnue.cuh"

namespace {

constexpr int FEATURES = 32 * nnue::NUM_PIECE_KINDS * 64;  // 22,528 (models/nnue.py NUM_FEATURES)
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCATTER_THREADS = 256;
constexpr int ROW_WARPS = 8;
constexpr int UNROLL = 8;  // d_acc values a thread loads ahead of their adds

// 1. feat[(2b + p) * 64 + sq]: the feature row of the piece on sq of
// board b seen from p, -1 where empty; count[row] += 1 for each
__global__ void features_kernel(const int32_t* __restrict__ boards, int* __restrict__ feat,
                                int* __restrict__ count) {
    __shared__ int ksq[2];
    const int b = blockIdx.x, sq = threadIdx.x;
    if (sq < 2) ksq[sq] = 64;
    __syncthreads();
    const int code = boards[(int64_t)b * 64 + sq];
    if (code == 6) atomicMin(&ksq[0], sq);   // white's king
    if (code == 12) atomicMin(&ksq[1], sq);  // black's
    __syncthreads();
    for (int p = 0; p < 2; ++p) {
        const int k = ksq[p] == 64 ? 0 : ksq[p];
        const int flip = p ? 56 : 0;
        const int mirror = ((k ^ flip) & 7) > 3 ? 7 : 0;
        const int o_ksq = (k ^ flip) ^ mirror;
        int f = -1;
        if (code > 0) {
            f = ((o_ksq >> 3) * 4 + (o_ksq & 7)) * (nnue::NUM_PIECE_KINDS * 64) +
                nnue::feature_kind(code, p) * 64 + ((sq ^ flip) ^ mirror);
            atomicAdd(&count[f], 1);
        }
        feat[((int64_t)b * 2 + p) * 64 + sq] = f;
    }
}

// 2. offset[r] = count[0] + ... + count[r - 1] for r <= n (one block; a
// round takes SCAN_ITEMS consecutive counts a thread, the block's
// SCAN_THREADS x SCAN_ITEMS together: the threads' totals scanned by warp
// shuffles, the 32 warp totals by warp 0, plus the rounds' carry)
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const int* __restrict__ count, int* __restrict__ offset, int n) {
    __shared__ int warp_sums[SCAN_THREADS / 32];
    __shared__ int carry;
    const int t = threadIdx.x, lane = t % 32, w = t / 32;
    if (t == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < n; base += SCAN_THREADS * SCAN_ITEMS) {
        const int first = base + t * SCAN_ITEMS;
        int v[SCAN_ITEMS], total = 0;
#pragma unroll
        for (int u = 0; u < SCAN_ITEMS; ++u) {
            v[u] = first + u < n ? count[first + u] : 0;
            total += v[u];
        }
        int x = total;  // the warp's inclusive sums of the threads' totals
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(nnue::FULL, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) warp_sums[w] = x;
        __syncthreads();
        if (w == 0) {
            int ws = warp_sums[lane];
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(nnue::FULL, ws, d);
                if (lane >= d) ws += y;
            }
            warp_sums[lane] = ws;
        }
        __syncthreads();
        int run = carry + (w ? warp_sums[w - 1] : 0) + x - total;
#pragma unroll
        for (int u = 0; u < SCAN_ITEMS; ++u) {
            if (first + u < n) offset[first + u] = run;
            run += v[u];
        }
        __syncthreads();
        if (t == SCAN_THREADS - 1) carry = run;
        __syncthreads();
    }
    if (t == 0) offset[n] = carry;
}

// 3. each triple's k = 2b + p into a slot of its row
__global__ void scatter_kernel(const int* __restrict__ feat, const int* __restrict__ offset,
                               int* __restrict__ fill, int* __restrict__ keys, int n) {
    const int i = blockIdx.x * SCATTER_THREADS + threadIdx.x;
    if (i >= n) return;
    const int f = feat[i];
    if (f >= 0) keys[offset[f] + atomicAdd(&fill[f], 1)] = i >> 6;
}

// Column c of d_acc's rows keys[0..n) (rows 0..n without keys) summed in
// that order from 0.0; the rows' values are loaded UNROLL at a time ahead
// of their adds, which stay in order.
template <bool kKeyed>
__device__ __forceinline__ float sum_in_order(const float* __restrict__ d_acc, const int* keys,
                                              int n, int l1, int c) {
    float s = 0.0f;
    int i = 0;
    for (; i + UNROLL <= n; i += UNROLL) {
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            v[u] = d_acc[(int64_t)(kKeyed ? keys[i + u] : i + u) * l1 + c];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) s = __fadd_rn(s, v[u]);
    }
    for (; i < n; ++i) s = __fadd_rn(s, d_acc[(int64_t)(kKeyed ? keys[i] : i) * l1 + c]);
    return s;
}

// A row's n keys (distinct, each in [0, pairs)) in ascending order into
// sorted (a warp): a bitmap of 1,024 keys at a time in shared memory, a
// word a thread, set by integer atomics and read back in bit order at
// each word's place (the warp's prefix sums of the words' counts).
__device__ __forceinline__ void order_keys(const int* keys, int n, int pairs, int* sorted,
                                           unsigned* bits, int t) {
    int done = 0;
    for (int lo = 0; lo < pairs && done < n; lo += 1024) {
        bits[t] = 0u;
        __syncwarp();
        for (int i = t; i < n; i += 32) {
            const int k = keys[i] - lo;
            if (k >= 0 && k < 1024) atomicOr(&bits[k >> 5], 1u << (k & 31));
        }
        __syncwarp();
        const unsigned word = bits[t];
        const int cnt = __popc(word);
        int incl = cnt;
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(nnue::FULL, incl, d);
            if (t >= d) incl += y;
        }
        int pos = done + incl - cnt;
        for (unsigned w = word; w; w &= w - 1) sorted[pos++] = lo + t * 32 + __ffs(w) - 1;
        done += __shfl_sync(nnue::FULL, incl, 31);
        __syncwarp();
    }
}

// 4. a warp a gradient row: rows 0..FEATURES-1 ft_w's, row FEATURES ft_b's
__global__ void __launch_bounds__(ROW_WARPS * 32)
rows_kernel(const float* __restrict__ d_acc, const int* __restrict__ offset,
            const int* __restrict__ keys, int* sorted, float* __restrict__ grad, int pairs,
            int l1) {
    const int t = threadIdx.x % 32;
    const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
    if (row > FEATURES) return;  // the whole warp
    float* out = grad + (int64_t)row * l1;
    if (row == FEATURES) {
        for (int c = t; c < l1; c += 32) out[c] = sum_in_order<false>(d_acc, nullptr, pairs, l1, c);
        return;
    }
    __shared__ unsigned bits[ROW_WARPS][32];
    const int start = offset[row], n = offset[row + 1] - start;
    if (n) order_keys(keys + start, n, pairs, sorted + start, bits[threadIdx.x / 32], t);
    for (int c = t; c < l1; c += 32) out[c] = sum_in_order<true>(d_acc, sorted + start, n, l1, c);
}

}  // namespace

// d_acc (batch, 2, l1) f32, boards (batch, 64) int32 → grad ((22528 + 1)
// x l1,) f32: ft_w's gradient (22,528 rows), then ft_b's. scratch: int32
// words, 3 x (22528 + 1) + 3 x batch x 128 of them (the rows' counts,
// cursors and offsets, then each triple's row, the keys as bucketed and
// as ordered), overwritten.
FISHNET_EXPORT int nnue_ft_backward_kb(const void* d_acc, const void* boards, void* grad,
                                       void* scratch, int batch, int l1, void* stream) {
    if (batch <= 0 || l1 <= 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const int n = batch * 128;
    int* count = (int*)scratch;
    int* fill = count + (FEATURES + 1);
    int* offset = fill + (FEATURES + 1);
    int* feat = offset + (FEATURES + 1);
    int* keys = feat + n;
    int* sorted = keys + n;
    cudaError_t e = cudaMemsetAsync(count, 0, 2 * (FEATURES + 1) * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
    features_kernel<<<batch, 64, 0, s>>>((const int32_t*)boards, feat, count);
    scan_kernel<<<1, SCAN_THREADS, 0, s>>>(count, offset, FEATURES);
    scatter_kernel<<<(n + SCATTER_THREADS - 1) / SCATTER_THREADS, SCATTER_THREADS, 0, s>>>(
        feat, offset, fill, keys, n);
    rows_kernel<<<(FEATURES + ROW_WARPS) / ROW_WARPS, ROW_WARPS * 32, 0, s>>>(
        (const float*)d_acc, offset, keys, sorted, (float*)grad, 2 * batch, l1);
    return (int)cudaGetLastError();
}
