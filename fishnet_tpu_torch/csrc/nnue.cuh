// The NNUE nets' per-lane bodies as device functions: the board768 layer
// stack from an accumulator pair (K2) and one column of its incremental
// accumulator update (K3), and the full evals of the nets without
// incremental accumulators: a king-bucketed (HalfKAv2_hm) NnueParams net
// (K12) and an imported Stockfish net (K13). K3's kernel wraps its body
// one column a thread, K2's and K12's one lane a warp; K13's eval is split
// into units any warp can run (sf_ft_unit, sf_fc0_unit, sf_finish), which
// its kernel spreads over its grid and K11 over its waiting warps. K17's
// refresh and K13's feature-transform units share row_sums, which keeps a
// group of rows' 16-byte loads in flight ahead of the adds. The segment
// kernel (K11) calls the same functions, so its evals and accumulators are
// the standalone kernels' bit for bit.
//
// Float order: every add and multiply of the K12/K13 bodies outside an
// explicit fmaf is written with __fadd_rn/__fmul_rn, which the compiler
// never contracts into a fused multiply-add, so a body gives the same bits
// wherever it is inlined; a warp sum is an xor butterfly, which leaves the
// same bits in every thread.
//
// bf16 nets (models/nnue.py cast_params) store every weight and bias in
// bf16 and compute in f32: each body reads a bf16 value and widens it
// with __bfloat162float at its load (wide), which is exact, and then runs
// the f32 body's arithmetic in the f32 body's order. No arithmetic is done
// in bf16, so a bf16 body gives the f32 body's bits on the widened
// weights. The conversions are explicit overloads, never
// __nv_bfloat16's own operator float, which beside the int8 overloads
// could pick the wrong one.
#pragma once
#include <cuda_bf16.h>

#include "common.cuh"
#include "search_consts.cuh"

namespace nnue {

// K2's widths: the shipped board768 net's (kernels.py SEGMENT_L1/H1/H2)
constexpr int L1 = consts::SEGMENT_L1;
constexpr int IN = 2 * L1;
constexpr int H1 = consts::SEGMENT_H1;
constexpr int H2 = consts::SEGMENT_H2;
constexpr int MAX_H = 32;  // the hidden widths K12's layer stack takes (kernels.py MAX_HIDDEN)
constexpr int QA = 127;
constexpr int QW_SHIFT = 6;
constexpr float OUTPUT_SCALE = 600.0f;
// OUTPUT_SCALE / (QA * QW) rounded once to f32, as the reference does
constexpr float INT8_SCALE = (float)(600.0 / (127.0 * 64.0));
constexpr int SLOTS = 4;  // piece changes a move makes
constexpr int NONE = 1 << 20;
constexpr int NUM_PIECE_KINDS = 11;  // HalfKAv2_hm: P N B R Q of each side, the kings
constexpr unsigned FULL = 0xffffffffu;
// an imported Stockfish net's layer stack (models/nnue_import.py)
constexpr int FC0_OUT = 16;  // 15 hidden + the skip row
constexpr int FC1_IN = 30;
constexpr int FC1_OUT = 32;
constexpr int PSQT_BUCKETS = 8;
constexpr float NNUE2SCORE = 600.0f;

// The output buckets' head weights: l1_w (8, 2*L1, H1), l1_b (8, H1),
// l2_w (8, H1, H2), l2_b (8, H2), out_w (8, H2), out_b (8,), and the
// widths, which K12 reads (H1, H2 <= MAX_H; K2 runs at its own).
template <typename W, typename B>
struct Head {
    const W* l1_w;
    const B* l1_b;
    const W* l2_w;
    const B* l2_b;
    const W* out_w;
    const B* out_b;
    int l1, h1, h2;
};

// A board768 or king-bucketed NnueParams net: ft_w (features, L1), ft_b
// (L1,) in the biases' type, the head. F/W/B: float for the f32 net;
// __nv_bfloat16 for the bf16 net; int16/int8/int32 for the int8 net.
template <typename F, typename W, typename B>
struct Net {
    using Ft = F;
    const F* ft_w;
    const B* ft_b;
    Head<W, B> head;
};

// The arithmetic type of a net whose biases are B: f32 for f32 and bf16
// nets, int32 for the int8 net (the accumulators' type).
template <typename B>
struct Wide {
    using type = B;
};
template <>
struct Wide<__nv_bfloat16> {
    using type = float;
};

// A stored weight or bias as the arithmetic reads it: bf16 widened
// exactly, every other type as it is.
__device__ __forceinline__ float wide(float x) { return x; }
__device__ __forceinline__ float wide(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int wide(int32_t x) { return x; }
__device__ __forceinline__ int wide(int16_t x) { return x; }

// An imported Stockfish net, f32: ft_w (22528, L1), ft_b (L1,), psqt_w
// (22528, 8), fc0_w (8, 16, L1), fc0_b (8, 16), fc1_w (8, 32, 30), fc1_b
// (8, 32), fc2_w (8, 1, 32), fc2_b (8, 1).
struct SfNet {
    const float* ft_w;
    const float* ft_b;
    const float* psqt_w;
    const float* fc0_w;
    const float* fc0_b;
    const float* fc1_w;
    const float* fc1_b;
    const float* fc2_w;
    const float* fc2_b;
    int l1;
    bool vec;  // the feature transform takes 16-byte loads (sf_vec_ok)
};

__device__ __forceinline__ float crelu(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ int clip_qa(int x) { return min(max(x, 0), QA); }

// the layer stack's steps on each net: the input activation, one
// multiply-add, a hidden unit's activation after its bias, the score
__device__ __forceinline__ float act_in(float x) { return crelu(x); }
__device__ __forceinline__ int act_in(int x) { return clip_qa(x); }
__device__ __forceinline__ float mac(float x, float w, float a) { return fmaf(x, w, a); }
__device__ __forceinline__ float mac(float x, __nv_bfloat16 w, float a) {
    return fmaf(x, __bfloat162float(w), a);
}
__device__ __forceinline__ int mac(int x, int8_t w, int a) { return a + x * (int)w; }
__device__ __forceinline__ float act_hidden(float v, float b) { return crelu(__fadd_rn(v, b)); }
__device__ __forceinline__ float act_hidden(float v, __nv_bfloat16 b) {
    return crelu(__fadd_rn(v, __bfloat162float(b)));
}
__device__ __forceinline__ int act_hidden(int v, int b) { return clip_qa((v + b) >> QW_SHIFT); }
__device__ __forceinline__ float times(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float times(float a, __nv_bfloat16 b) {
    return __fmul_rn(a, __bfloat162float(b));
}
__device__ __forceinline__ int times(int a, int8_t b) { return a * (int)b; }
__device__ __forceinline__ float score(float o, float b) { return __fadd_rn(o, b) * OUTPUT_SCALE; }
__device__ __forceinline__ float score(float o, __nv_bfloat16 b) {
    return __fadd_rn(o, __bfloat162float(b)) * OUTPUT_SCALE;
}
__device__ __forceinline__ float score(int o, int b) { return (float)(o + b) * INT8_SCALE; }

__device__ __forceinline__ float warp_sum(float v) {
    for (int m = 16; m; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, m));
    return v;
}
__device__ __forceinline__ int warp_sum(int v) {
    for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
    return v;
}

// K2's body on the f32 net (W float) and the bf16 net (W __nv_bfloat16,
// each weight widened at its load), one lane a warp: own/opp are the side
// to move's and the other side's L1 f32 accumulator columns, staged in the
// warp's shared memory, b the output bucket. Each hidden unit is its own
// chain of fused multiply-adds in input order, in f32, as one thread
// computed it before: thread j < H1 sums first-layer unit j over k = 0 ...
// IN-1 with its weights loaded a chunk ahead of the chain, the units go
// round the warp by shuffles, thread j < H2 sums second-layer unit j over
// k = 0 ... H1-1, and every thread runs the output's chain over the
// shuffled second-layer values in k order. No sum is split across
// threads, so every caller gets the bits of the one-thread chain.
// Returns the eval in every thread.
template <typename W>
__device__ __forceinline__ float forward_warp(const float* own, const float* opp, int b,
                                              const Head<W, W>& w, int t) {
    static_assert(H1 <= 32 && H2 <= 32, "K2: a hidden unit a thread");
    constexpr int CHUNK = 32;  // first-layer weights in flight a thread
    static_assert(IN % CHUNK == 0, "K2: whole chunks");
    float h1 = 0.0f;
    if (t < H1) {
        const W* w1 = w.l1_w + (int64_t)b * IN * H1 + t;
#pragma unroll
        for (int k0 = 0; k0 < IN; k0 += CHUNK) {
            float wk[CHUNK];
#pragma unroll
            for (int i = 0; i < CHUNK; ++i) wk[i] = wide(w1[(k0 + i) * H1]);
#pragma unroll
            for (int i = 0; i < CHUNK; ++i) {
                const int k = k0 + i;
                h1 = fmaf(crelu(k < L1 ? own[k] : opp[k - L1]), wk[i], h1);
            }
        }
        h1 = crelu(h1 + wide(w.l1_b[b * H1 + t]));
    }
    // every thread runs the shuffles; threads j >= H2 sum nothing they keep
    const W* w2 = w.l2_w + (int64_t)b * H1 * H2 + t;
    float wk[H1];
#pragma unroll
    for (int k = 0; k < H1; ++k) wk[k] = t < H2 ? wide(w2[k * H2]) : 0.0f;
    const float ow = t < H2 ? wide(w.out_w[b * H2 + t]) : 0.0f;
    float h2 = 0.0f;
#pragma unroll
    for (int k = 0; k < H1; ++k) h2 = fmaf(__shfl_sync(FULL, h1, k), wk[k], h2);
    const float a2 = t < H2 ? crelu(h2 + wide(w.l2_b[b * H2 + t])) : 0.0f;
    float o = 0.0f;
#pragma unroll
    for (int k = 0; k < H2; ++k) {
        o = fmaf(__shfl_sync(FULL, a2, k), __shfl_sync(FULL, ow, k), o);
    }
    return (o + wide(w.out_b[b])) * OUTPUT_SCALE;
}

// K2's body on the int8 net, one lane a warp: the fixed-point ladder
// (activations [0, QA], weights in 1/64 steps, >> 6 between layers),
// exact integer arithmetic, so the sums may split: first-layer unit j is
// summed by threads j (own's columns) and j + 16 (opp's) and the halves
// added; thread j < H2 sums second-layer unit j, and a warp sum gives the
// output. Returns the eval in every thread.
__device__ __forceinline__ float forward_warp(const int32_t* own, const int32_t* opp, int b,
                                              const Head<int8_t, int32_t>& w, int t) {
    static_assert(2 * H1 == 32 && IN == 2 * L1 && H2 <= 32, "K2 int8: a half-warp a side");
    const int j = t % H1, half = t / H1;
    const int32_t* x = half ? opp : own;
    const int8_t* w1 = w.l1_w + ((int64_t)b * IN + half * L1) * H1 + j;
    int part = 0;
#pragma unroll 16
    for (int k = 0; k < L1; ++k) part += clip_qa(x[k]) * (int)w1[k * H1];
    const int h1 = clip_qa((part + __shfl_down_sync(FULL, part, H1) + w.l1_b[b * H1 + j])
                           >> QW_SHIFT);  // threads j < H1
    int h2 = 0;
    const int8_t* w2 = w.l2_w + (int64_t)b * H1 * H2 + t;
#pragma unroll
    for (int k = 0; k < H1; ++k) {
        const int hk = __shfl_sync(FULL, h1, k);
        if (t < H2) h2 += hk * (int)w2[k * H2];
    }
    int v = 0;
    if (t < H2) v = clip_qa((h2 + w.l2_b[b * H2 + t]) >> QW_SHIFT) * (int)w.out_w[b * H2 + t];
    return (float)(warp_sum(v) + w.out_b[b]) * INT8_SCALE;
}

// K3's body: the signed sum of the <= 4 changed feature rows of one lane
// (f32; bf16 widened at its load; int16 into int32), for perspective
// `persp` and accumulator column `col` (the child is the parent's column
// plus this). Equal features merge into one weight (a
// chess960 castle can move a piece onto its own square: +1 and -1
// cancel, as the reference's weight vector does), and rows are added in
// the order XLA:CPU reduces the reference's 768-long contraction:
// increasing feature index, rows of one 32-row block summed in order,
// block sums added in order.
template <typename W, typename A>
__device__ __forceinline__ A acc_delta(const int32_t* codes, const int32_t* sqs,
                                       const int32_t* signs, int persp, int col, const W* ft_w,
                                       int l1) {
    int idx[SLOTS], w[SLOTS];
    for (int i = 0; i < SLOTS; ++i) {
        int code = codes[i];
        idx[i] = code > 0 ? feature_768(code, sqs[i], persp) : NONE;
        w[i] = signs[i];
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
        block = block + (A)wide(ft_w[(int64_t)idx[i] * l1 + col]) * (A)w[i];
    }
    return total + block;
}

// ------------------------------------------------ the full-eval nets (K12, K13)

// The HalfKAv2_hm feature rows of one board's pieces for both
// perspectives, in square order: idx[p][0, lo[p]) from squares 0-31,
// idx[p][lo[p], n[p]) from squares 32-63.
struct Features {
    int idx[2][64];
    int lo[2];
    int n[2];
};

// HalfKAv2_hm piece kind of a code seen from perspective p: own P..Q 0-4,
// the opponent's 5-9, either king 10 (models/nnue.py feature_indices).
__device__ __forceinline__ int feature_kind(int code, int p) {
    const int pt = (code - 1) % 6;
    const int color = code <= 6 ? 0 : 1;
    return pt == 5 ? 10 : (color == p ? pt : 5 + pt);
}

// One board's feature lists (a warp; board: its 64 codes, global or
// shared). Each perspective's king square is its first king (a square 0
// without one); black's view flips ranks, then files mirror so that king
// sits on files a-d, whose rank and file give the bucket.
__device__ __forceinline__ void features_warp(const int32_t* board, int t, Features& f) {
    const int c0 = board[t], c1 = board[t + 32];
    const unsigned below = (1u << t) - 1u;
    const unsigned m0 = __ballot_sync(FULL, c0 > 0), m1 = __ballot_sync(FULL, c1 > 0);
    const int lo = __popc(m0);
    for (int p = 0; p < 2; ++p) {
        const int king = 6 + 6 * p;
        const unsigned k0 = __ballot_sync(FULL, c0 == king);
        const unsigned k1 = __ballot_sync(FULL, c1 == king);
        const int ksq = k0 ? __ffs(k0) - 1 : (k1 ? 31 + __ffs(k1) : 0);
        const int flip = p ? 56 : 0;
        const int mirror = ((ksq ^ flip) & 7) > 3 ? 7 : 0;
        const int o_ksq = (ksq ^ flip) ^ mirror;
        const int base = ((o_ksq >> 3) * 4 + (o_ksq & 7)) * (NUM_PIECE_KINDS * 64);
        if (c0 > 0) {
            f.idx[p][__popc(m0 & below)] = base + feature_kind(c0, p) * 64 + ((t ^ flip) ^ mirror);
        }
        if (c1 > 0) {
            f.idx[p][lo + __popc(m1 & below)] =
                base + feature_kind(c1, p) * 64 + (((t + 32) ^ flip) ^ mirror);
        }
    }
    if (t == 0) {
        f.lo[0] = f.lo[1] = lo;
        f.n[0] = f.n[1] = lo + __popc(m1);
    }
    __syncwarp();
}

// One board's board768 feature rows (K1's, common.cuh feature_768) for
// both perspectives in the same lists and the same square order, so that
// refresh_column sums them as K1 does (atomic's board768 leaf in K11).
__device__ __forceinline__ void features_768_warp(const int32_t* board, int t, Features& f) {
    const int c0 = board[t], c1 = board[t + 32];
    const unsigned below = (1u << t) - 1u;
    const unsigned m0 = __ballot_sync(FULL, c0 > 0), m1 = __ballot_sync(FULL, c1 > 0);
    const int lo = __popc(m0);
    for (int p = 0; p < 2; ++p) {
        if (c0 > 0) f.idx[p][__popc(m0 & below)] = feature_768(c0, t, p);
        if (c1 > 0) f.idx[p][lo + __popc(m1 & below)] = feature_768(c1, t + 32, p);
    }
    if (t == 0) {
        f.lo[0] = f.lo[1] = lo;
        f.n[0] = f.n[1] = lo + __popc(m1);
    }
    __syncwarp();
}

// The output bucket from the piece count (models/nnue.py output_bucket).
__device__ __forceinline__ int output_bucket(const Features& f) {
    return min(max((f.n[0] - 1) / 4, 0), 7);
}

// One column of perspective p's refresh without its bias: the pieces'
// rows (bf16 widened at its load) summed in the reference's order
// (squares 0-31 and 32-63 each in order, then the halves added;
// models/nnue.py sum_rows).
template <typename F, typename A>
__device__ __forceinline__ A refresh_column(const Features& f, int p, const F* ft_w, int l1,
                                            int c) {
    A s0 = 0, s1 = 0;
    const int lo = f.lo[p], n = f.n[p];
    for (int i = 0; i < lo; ++i) s0 = s0 + (A)wide(ft_w[(int64_t)f.idx[p][i] * l1 + c]);
    for (int i = lo; i < n; ++i) s1 = s1 + (A)wide(ft_w[(int64_t)f.idx[p][i] * l1 + c]);
    return s0 + s1;
}

// K12's body: a king-bucketed net's full eval of one lane (a warp), f32
// (F, W, B float), bf16 (__nv_bfloat16, computed in f32) or int8 (int16,
// int8, int32). Each thread refreshes the columns c = t, t + 32, ... of
// both perspectives (ft_b + the pieces' rows, the reference's order, so
// the accumulators are the plain version's bit for bit) and folds them
// straight into its partial sums of the H1 first-layer units; a warp sum
// finishes each unit, thread j computes second-layer unit j, and a warp
// sum the output.
template <typename F, typename W, typename B>
__device__ float evaluate_warp(const Features& f, int stm, int bucket, const Net<F, W, B>& net,
                               int t) {
    using A = typename Wide<B>::type;
    const Head<W, B>& w = net.head;
    const int l1 = w.l1, n1 = w.h1, n2 = w.h2;
    const W* w1 = w.l1_w + (int64_t)bucket * 2 * l1 * n1;
    A part[MAX_H];
#pragma unroll
    for (int j = 0; j < MAX_H; ++j) part[j] = 0;
    for (int c = t; c < l1; c += 32) {
        const A bias = wide(net.ft_b[c]);
        const A x_own = act_in(bias + refresh_column<F, A>(f, stm, net.ft_w, l1, c));
        const A x_opp = act_in(bias + refresh_column<F, A>(f, 1 - stm, net.ft_w, l1, c));
        const W* r_own = w1 + (int64_t)c * n1;
        const W* r_opp = w1 + (int64_t)(l1 + c) * n1;
#pragma unroll
        for (int j = 0; j < MAX_H; ++j) {
            if (j < n1) part[j] = mac(x_opp, r_opp[j], mac(x_own, r_own[j], part[j]));
        }
    }
    A h1[MAX_H];
#pragma unroll
    for (int j = 0; j < MAX_H; ++j) {
        h1[j] = 0;
        if (j < n1) h1[j] = act_hidden(warp_sum(part[j]), w.l1_b[bucket * n1 + j]);
    }
    A v = 0;
    if (t < n2) {
        const W* w2 = w.l2_w + (int64_t)bucket * n1 * n2 + t;
        A u = 0;
#pragma unroll
        for (int k = 0; k < MAX_H; ++k) {
            if (k < n1) u = mac(h1[k], w2[k * n2], u);
        }
        v = times(act_hidden(u, w.l2_b[bucket * n2 + t]), w.out_w[bucket * n2 + t]);
    }
    return score(warp_sum(v), w.out_b[bucket]);
}

// ------------------------------------------- rows in flight (K17, K13)

// A column's value as f32 lanes: one float, or four neighbouring floats
// read with one 16-byte load.
__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                       __fadd_rn(a.w, b.w));
}

// The sums of the rows idx[0, n) of a row-major f32 table (`stride`
// vectors a row) at K vector columns col[k] (each a pointer to its
// column in row 0), in refresh_column's order: squares 0-31 ([0, lo))
// and 32-63 ([lo, n)) each summed in order, then the halves added. The
// rows' loads go out G rows at a time, each group's loads issued before
// the adds of the group before it, and a group's indices are read into
// registers before any of its loads; the adds run in the old order, so
// every sum is refresh_column's bit for bit. n and lo must be the same in
// every thread of the warp that reaches a warp-wide call.
template <int K, int G, class T>
__device__ __forceinline__ void row_sums(const int* idx, int lo, int n, const T* const (&col)[K],
                                         int64_t stride, T (&out)[K]) {
    T s0[K], s1[K], cur[G][K];
#pragma unroll
    for (int k = 0; k < K; ++k) s0[k] = s1[k] = vzero(T{});
    auto load = [&](int i0, T (&r)[G][K]) {
        int row[G];
#pragma unroll
        for (int g = 0; g < G; ++g) row[g] = i0 + g < n ? idx[i0 + g] : 0;
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                r[g][k] = i0 + g < n ? __ldg(col[k] + (int64_t)row[g] * stride) : vzero(T{});
            }
        }
    };
    load(0, cur);
    for (int i0 = 0; i0 < n; i0 += G) {
        T next[G][K];
        if (i0 + G < n) load(i0 + G, next);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (i0 + g < lo) {
                    s0[k] = vadd(s0[k], cur[g][k]);
                } else if (i0 + g < n) {
                    s1[k] = vadd(s1[k], cur[g][k]);
                }
            }
        }
        if (i0 + G < n) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
#pragma unroll
                for (int k = 0; k < K; ++k) cur[g][k] = next[g][k];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = vadd(s0[k], s1[k]);
}

// --------------------------------------------- K13 in units any warp runs

// K13's eval split into units that any warp can run, each on its own
// rows and none waiting on another (K11 spreads them over its warps, the
// standalone kernel over its grid):
// - a feature-transform unit u (sf_ft_unit): perspective q = u % 2 (0 the
//   side to move's) and the column slice u / 2 of both halves, a thread
//   four neighbouring columns (one if the net's widths or pointers do not
//   allow 16-byte loads: SfNet::vec); it writes the pairwise clipped
//   products x[q * L1/2 + c] into the eval's buffer, SF_X_W(L1) floats;
// - an fc0 unit i (sf_fc0_unit), once every feature-transform unit is
//   done: thread t runs chain (i, t) of the bucket's fc0, over the
//   columns c = t, t + 32, ... in ascending order, own then opp at each,
//   and writes it into the eval's 16 x 32 chain sums after the buffer;
// - the owner (sf_finish), once every fc0 unit is done: warp sums close
//   the chains, then fc1, fc2 and the PSQT sums of the bucket.
// Every column, chain and sum keeps the order of the one-warp body it
// replaces, so the eval's bits do not depend on which warp ran a unit.
constexpr int SF_SLICE_VEC = 4 * 32;  // columns of a slice, four a thread
constexpr int SF_SLICE_SCALAR = 32;  // one a thread
constexpr int SF_CHAINS = FC0_OUT * 32;  // the fc0 chains' sums after the buffer
constexpr int SF_FC0_UNITS = FC0_OUT;  // a row of fc0 a unit
constexpr int SF_FC0_CHUNK = 8;  // a chain's steps whose loads go out together
constexpr int SF_ROW_GROUP = 4;  // a unit's rows whose loads go out together (x2 columns)

// An eval's buffer: the products x (L1 floats, rounded up to whole
// vectors), then the chain sums.
__host__ __device__ __forceinline__ int sf_x_stride(int l1) { return (l1 + 3) / 4 * 4; }
__host__ __device__ __forceinline__ int sf_buffer_floats(int l1) {
    return sf_x_stride(l1) + SF_CHAINS;
}
__host__ __device__ __forceinline__ int sf_ft_units(const SfNet& net) {
    const int half = net.l1 / 2, slice = net.vec ? SF_SLICE_VEC : SF_SLICE_SCALAR;
    return 2 * ((half + slice - 1) / slice);
}
// Whether a net's feature transform takes 16-byte loads: L1/2 whole
// vectors, ft_w and ft_b 16-byte aligned.
inline bool sf_vec_ok(const float* ft_w, const float* ft_b, int l1) {
    return (l1 / 2) % 4 == 0 && (uintptr_t)ft_w % 16 == 0 && (uintptr_t)ft_b % 16 == 0;
}

__device__ __forceinline__ float4 sf_pair(float4 a, float4 b) {
    return make_float4(__fmul_rn(crelu(a.x), crelu(b.x)), __fmul_rn(crelu(a.y), crelu(b.y)),
                       __fmul_rn(crelu(a.z), crelu(b.z)), __fmul_rn(crelu(a.w), crelu(b.w)));
}
__device__ __forceinline__ float sf_pair(float a, float b) {
    return __fmul_rn(crelu(a), crelu(b));
}

// One feature-transform unit's columns c and c + L1/2 (vector type T) of
// perspective p: ft_b + the pieces' rows, paired, clipped, multiplied.
template <class T>
__device__ __forceinline__ T sf_columns(const Features& f, int p, const SfNet& net, int c) {
    const int half = net.l1 / 2;
    const T* w = reinterpret_cast<const T*>(net.ft_w);
    const T* b = reinterpret_cast<const T*>(net.ft_b);
    constexpr int V = sizeof(T) / sizeof(float);
    const T* const col[2] = {w + c / V, w + (c + half) / V};
    T sum[2];
    row_sums<2, SF_ROW_GROUP>(f.idx[p], f.lo[p], f.n[p], col, net.l1 / V, sum);
    return sf_pair(vadd(__ldg(b + c / V), sum[0]), vadd(__ldg(b + (c + half) / V), sum[1]));
}

// Feature-transform unit u of the eval of the board whose lists are f
// (the warp's shared copy), side to move stm, into its buffer x.
__device__ __noinline__ void sf_ft_unit(const Features& f, int stm, int u, const SfNet& net,
                                        float* x, int t) {
    const int half = net.l1 / 2, q = u & 1, p = q ? 1 - stm : stm;
    if (net.vec) {
        const int c = (u >> 1) * SF_SLICE_VEC + 4 * t;
        if (c < half) __stcg(reinterpret_cast<float4*>(x + q * half + c),
                             sf_columns<float4>(f, p, net, c));
    } else {
        const int c = (u >> 1) * SF_SLICE_SCALAR + t;
        if (c < half) __stcg(x + q * half + c, sf_columns<float>(f, p, net, c));
    }
}

// fc0 unit i of an eval in bucket `bucket` from its products x: chain
// (i, t) into chains[i * 32 + t]. x comes from other warps: read through
// L2.
__device__ __noinline__ void sf_fc0_unit(int bucket, int i, const SfNet& net, const float* x,
                                         float* chains, int t) {
    const int l1 = net.l1, half = l1 / 2;
    const float* w = net.fc0_w + ((int64_t)bucket * FC0_OUT + i) * l1;
    float part = 0.0f;
    for (int c0 = t; c0 < half; c0 += 32 * SF_FC0_CHUNK) {
        float w0[SF_FC0_CHUNK], w1[SF_FC0_CHUNK], x0[SF_FC0_CHUNK], x1[SF_FC0_CHUNK];
#pragma unroll
        for (int k = 0; k < SF_FC0_CHUNK; ++k) {
            const int c = c0 + 32 * k;
            if (c < half) {
                w0[k] = __ldg(w + c);
                w1[k] = __ldg(w + half + c);
                x0[k] = __ldcg(x + c);
                x1[k] = __ldcg(x + half + c);
            }
        }
#pragma unroll
        for (int k = 0; k < SF_FC0_CHUNK; ++k) {
            if (c0 + 32 * k < half) part = fmaf(w1[k], x1[k], fmaf(w0[k], x0[k], part));
        }
    }
    __stcg(chains + i * 32 + t, part);
}

// The owner's close of an eval (its warp, with the board's lists f):
// warp sums finish fc0 from the chains; thread j computes fc1 unit j on
// [clip(h), clip(h)^2] and its fc2 term, a warp sum the output; the PSQT
// column of the bucket is summed in the reference's order from one value
// a feature, loaded by all threads. Returns the eval in every thread.
__device__ __noinline__ float sf_finish(const Features& f, int stm, int bucket, const SfNet& net,
                                        const float* chains, int t) {
    float h0[FC0_OUT];
#pragma unroll
    for (int i = 0; i < FC0_OUT; ++i) {
        h0[i] = __fadd_rn(warp_sum(__ldcg(chains + i * 32 + t)), net.fc0_b[bucket * FC0_OUT + i]);
    }
    // fc1 unit t (FC1_OUT == 32 == the warp) and its fc2 term
    const float* w1 = net.fc1_w + ((int64_t)bucket * FC1_OUT + t) * FC1_IN;
    float u = 0.0f;
#pragma unroll
    for (int k = 0; k < FC0_OUT - 1; ++k) u = fmaf(w1[k], crelu(h0[k]), u);
#pragma unroll
    for (int k = 0; k < FC0_OUT - 1; ++k) {
        const float h = crelu(h0[k]);
        u = fmaf(w1[FC0_OUT - 1 + k], __fmul_rn(h, h), u);
    }
    const float v = __fmul_rn(crelu(__fadd_rn(u, net.fc1_b[bucket * FC1_OUT + t])),
                              net.fc2_w[bucket * FC1_OUT + t]);
    const float out = __fadd_rn(warp_sum(v), net.fc2_b[bucket]);
    // the PSQT sums of the bucket, side to move first
    float ps[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int p = q ? 1 - stm : stm;
        const int lo = f.lo[p], n = f.n[p];
        const float v0 = t < n ? net.psqt_w[(int64_t)f.idx[p][t] * PSQT_BUCKETS + bucket] : 0.0f;
        const float v1 =
            t + 32 < n ? net.psqt_w[(int64_t)f.idx[p][t + 32] * PSQT_BUCKETS + bucket] : 0.0f;
        float s0 = 0.0f, s1 = 0.0f;
        for (int i = 0; i < n; ++i) {
            const float e = __shfl_sync(FULL, i < 32 ? v0 : v1, i & 31);
            if (i < lo) {
                s0 = __fadd_rn(s0, e);
            } else {
                s1 = __fadd_rn(s1, e);
            }
        }
        ps[q] = __fadd_rn(s0, s1);
    }
    const float psqt = __fsub_rn(ps[0], ps[1]) / 2.0f;
    return __fmul_rn(__fadd_rn(__fadd_rn(out, h0[FC0_OUT - 1]), psqt), NNUE2SCORE);
}

}  // namespace nnue
