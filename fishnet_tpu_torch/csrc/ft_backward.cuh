// The trainer's feature-transform backward (K15 board768, K18 HalfKAv2_hm)
// as one design over the two feature sets: ft_w's gradient row f collects
// d_acc[b, p, :] of every (sample b, perspective p) whose board has, seen
// from p, the piece of feature f on its square; ft_b's gradient is d_acc
// summed over samples and both perspectives.
//
// Order: every row, and ft_b, is summed from 0.0 over its pairs k = 2b + p
// in ascending order with __fadd_rn, each column on its own: the order of
// the plain versions (models/train.py _ft_backward_plain, an in-order CPU
// index_add_; a pair puts one square in a row), so the kernels give their
// bytes. No float atomics: two launches on the same inputs give the same
// bytes, and a tp shard's column block gives those columns of the whole.
//
// Bound on the H100: bytes (d_acc and the boards read, the gradient
// written; K18's 5.8 MB of gradient at L1 64 is nearly all of it). What
// sets the time instead is latency: each column's chain of dependent adds
// (2B of them for ft_b and for a row every pair shares) and the global
// round trips in front of them.
//
// Design: an ordered inverse index, a window of WINDOW pairs at a time,
// four launches a window:
//   1. mark: a lane a sample, a warp a square; each (sample, perspective,
//      square)'s feature row f gets bit k = 2b + p in row f's WORDS words.
//      The lanes of a half warp (16 samples: one word) that hit one row are
//      merged first (__match_any_sync), so a word takes one integer atomicOr
//      from each half warp that touches it.
//   2. rows: a warp ROWS_PER_WARP rows, a lane a word. It reads their words
//      (and clears them for the next window) and counts each row's keys. A
//      row without keys gets zeros; a row of at most LIGHT keys is summed
//      here, its keys expanded in bit order (popcount, a warp prefix sum,
//      __ffs) and every load of the warp's rows issued before the first
//      add, lanes a column; a heavier row goes to the list with its words
//      (one atomic a warp).
//   3. sums: a block a 32-column slice and a share of the list: it copies
//      the slice of every pair of the window into shared memory (128 KB at
//      a full window), its loads all in flight at once, while the passes
//      before it run; then a warp a listed row expands its keys and sums
//      its column from shared memory in key order, loads running AHEAD keys
//      ahead of the adds. The last block to finish empties the list.
//   4. ft_b: a block a slice, copied the same way, one warp adding every
//      pair in order. Nothing waits for it, so it runs beside the sums.
// Passes 2-4 launch early (programmatic stream serialization) and wait
// only where they read what the pass before wrote. A chain whose loads wait
// on global round trips runs at one add a round trip; from shared memory it
// runs near the add's own latency, and the rows with few keys, which are
// most, cost one round trip a warp.
// A batch of more than WINDOW / 2 samples runs window after window; each
// column's running sum carries from one to the next through the gradient
// buffer (read back as the next window's start), so the order is the one
// sum's. The scratch is zero between calls: the bitmap (WORDS words a
// row), the list's count and finished blocks, then its entries. A padding
// key adds +0.0 from a zero row, which leaves a sum unchanged: a sum from
// +0.0 is never -0.0.
#pragma once
#include <algorithm>

#include "nnue.cuh"

// internal linkage: the two libraries that include this header define
// the same helper instantiations
namespace {
namespace ftb {

constexpr int WINDOW = consts::FT_WINDOW;  // (sample, perspective) pairs a window
constexpr int WORDS = WINDOW / 32;         // a row's bitmap words
constexpr int WINDOW_SAMPLES = WINDOW / 2;
constexpr int THREADS = 256;               // mark and rows: 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int MARK_SAMPLES = 32;           // a mark block's samples, a lane each
constexpr int ROWS_PER_WARP = 4;
constexpr int LIGHT = 4;                   // keys a row the row pass sums itself
constexpr int SUM_THREADS = 512;           // sums: 16 warps a block
constexpr int SUM_WARPS = SUM_THREADS / 32;
constexpr int AHEAD = 16;                  // keys a shared-memory chain loads ahead of its adds
constexpr int PAD = 3 * AHEAD;             // zero rows after a slice, padding keys after a row
constexpr int KEYS = WINDOW + PAD;         // a sum warp's keys, padded
constexpr int SHORT = 8;                   // keys a row summed without the pipelined chain
constexpr int LIST_HEAD = 4;               // the list's count, finished blocks, two spare
constexpr int ENTRY = 4 + WORDS;           // a list entry: row, key count, two spare, its words
// shared memory for a window of `pairs` pairs: a slice, and the sum pass's
// slice and warps' keys
__host__ __device__ constexpr int slice_smem(int pairs) { return (pairs + PAD) * 32 * 4; }
__host__ __device__ constexpr int sum_smem(int pairs) {
    return slice_smem(pairs) + SUM_WARPS * KEYS * 4;
}

// board768: 768 rows, no king (common.cuh feature_768)
struct Board768 {
    static constexpr int kRows = 768;
    static constexpr bool kKing = false;
    __device__ static int row(int code, int sq, int p, int) { return feature_768(code, sq, p); }
};

// HalfKAv2_hm: 22,528 rows; the perspective's king bucket, its flip and
// mirror (models/nnue.py feature_indices; nnue.cuh features_warp)
struct HalfKav2Hm {
    static constexpr int kRows = 32 * nnue::NUM_PIECE_KINDS * 64;
    static constexpr bool kKing = true;
    __device__ static int row(int code, int sq, int p, int ksq) {
        const int flip = p ? 56 : 0;
        const int mirror = ((ksq ^ flip) & 7) > 3 ? 7 : 0;
        const int o_ksq = (ksq ^ flip) ^ mirror;
        return ((o_ksq >> 3) * 4 + (o_ksq & 7)) * (nnue::NUM_PIECE_KINDS * 64) +
               nnue::feature_kind(code, p) * 64 + ((sq ^ flip) ^ mirror);
    }
};

// bit i of x's low 16 bits → bit 2i
__device__ __forceinline__ unsigned spread16(unsigned x) {
    x &= 0xffffu;
    x = (x | (x << 8)) & 0x00ff00ffu;
    x = (x | (x << 4)) & 0x0f0f0f0fu;
    x = (x | (x << 2)) & 0x33333333u;
    return (x | (x << 1)) & 0x55555555u;
}

// A row's keys k (its words, word j in lane j), ascending, into keys[0..n)
// as k * scale (a warp) → n
__device__ __forceinline__ int expand(unsigned word, unsigned* keys, unsigned scale, int lane) {
    const int cnt = __popc(word);
    int incl = cnt;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(nnue::FULL, incl, d);
        if (lane >= d) incl += y;
    }
    int pos = incl - cnt;
    for (unsigned x = word; x; x &= x - 1) keys[pos++] = (lane * 32u + __ffs(x) - 1) * scale;
    return __shfl_sync(nnue::FULL, incl, 31);
}

// s plus col[off] for the offsets off of offs[0..n), in that order: col
// is a lane's column of a slice in shared memory (rows of 32 floats, zero
// rows after its pairs), n a multiple of 2 AHEAD, offs 16-byte aligned and
// padded to n + 2 AHEAD with a zero row's
__device__ __forceinline__ float smem_chain(const float* col, const unsigned* offs, int n,
                                            float s) {
    float a[AHEAD], b[AHEAD];
    auto get = [&](float (&v)[AHEAD], int i) {
#pragma unroll
        for (int u = 0; u < AHEAD; u += 4) {
            const uint4 q = *reinterpret_cast<const uint4*>(offs + i + u);
            v[u] = col[q.x];
            v[u + 1] = col[q.y];
            v[u + 2] = col[q.z];
            v[u + 3] = col[q.w];
        }
    };
    get(a, 0);
    for (int i = 0; i < n; i += 2 * AHEAD) {
        get(b, i + AHEAD);
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) s = __fadd_rn(s, a[u]);
        get(a, i + 2 * AHEAD);
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) s = __fadd_rn(s, b[u]);
    }
    return s;
}

// v = *p where pred, else 0: a predicated load, no branch, so a run of
// them stays in flight together
__device__ __forceinline__ float load_if(const float* p, int pred) {
    float v;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\tmov.b32 %0, 0;\n\t"
        "@q ld.global.nc.f32 %0, [%1];\n\t}"
        : "=f"(v) : "l"(p), "r"(pred));
    return v;
}

__device__ __forceinline__ float4 load4_if(const float* p, int pred) {
    float4 v;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %5, 0;\n\tmov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\t"
        "mov.b32 %2, 0;\n\tmov.b32 %3, 0;\n\t"
        "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "r"(pred));
    return v;
}

// griddepcontrol: a kernel launched after another with programmatic
// stream serialization may start before it ends; wait() blocks until the
// one before has finished and its writes are visible, and a kernel lets
// the next one start early with let_next_start()
__device__ __forceinline__ void wait_for_previous() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_next_start() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// 1. mark, over a window of `samples` samples (boards offset to it): a
// block MARK_SAMPLES samples and WARPS squares
template <class Set>
__global__ void __launch_bounds__(THREADS)
mark_kernel(const int32_t* __restrict__ boards, unsigned* __restrict__ bits, int samples) {
    __shared__ int code[MARK_SAMPLES][65];  // padded: a lane a sample reads one bank each
    __shared__ int ksq[MARK_SAMPLES][2];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int s0 = blockIdx.x * MARK_SAMPLES;
    let_next_start();
    for (int i = threadIdx.x; i < MARK_SAMPLES * 64; i += THREADS) {
        const int s = i >> 6, sq = i & 63;
        code[s][sq] = s0 + s < samples ? boards[(int64_t)(s0 + s) * 64 + sq] : 0;
    }
    __syncthreads();
    if (Set::kKing) {  // each perspective's king square: its first king, 0 without one
        for (int s = w; s < MARK_SAMPLES; s += WARPS) {
            const int c0 = code[s][lane], c1 = code[s][lane + 32];
            for (int p = 0; p < 2; ++p) {
                const int king = 6 + 6 * p;
                const unsigned k0 = __ballot_sync(nnue::FULL, c0 == king);
                const unsigned k1 = __ballot_sync(nnue::FULL, c1 == king);
                if (lane == 0) ksq[s][p] = k0 ? __ffs(k0) - 1 : (k1 ? 31 + __ffs(k1) : 0);
            }
        }
        __syncthreads();
    }
    // square blockIdx.y * WARPS + w; the lane's pairs k = 2 (s0 + lane) + p:
    // word k / 32 of a row, bit 2 (lane % 16) + p
    const int sq = blockIdx.y * WARPS + w, word = (s0 + lane) >> 4;
    const int c = code[lane][sq];
    for (int p = 0; p < 2; ++p) {
        const int f = c > 0 ? Set::row(c, sq, p, Set::kKing ? ksq[lane][p] : 0) : -1;
        const unsigned m = __match_any_sync(
            nnue::FULL, f < 0 ? 0xffffffffu : (unsigned)(2 * f + (lane >> 4)));
        if (f >= 0 && lane == __ffs(m) - 1) {
            atomicOr(bits + (int64_t)f * WORDS + word, spread16(m >> (lane & 16)) << p);
        }
    }
}

// 2. rows, over the window (d_acc offset to it): a warp ROWS_PER_WARP rows
template <class Set>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const float* __restrict__ d_acc, unsigned* __restrict__ bits,
            unsigned* __restrict__ list, float* __restrict__ grad, int l1, int first) {
    __shared__ unsigned light[WARPS][ROWS_PER_WARP][LIGHT];  // a light row's keys k, as k * l1
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int row0 = (blockIdx.x * WARPS + w) * ROWS_PER_WARP;
    let_next_start();
    wait_for_previous();  // the mark pass's bits
    unsigned words[ROWS_PER_WARP];
    int n[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int row = min(row0 + i, Set::kRows - 1);
        words[i] = bits[(int64_t)row * WORDS + lane];
    }
    unsigned heavy = 0u;  // the warp's rows of more than LIGHT keys
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int row = row0 + i;
        n[i] = 0;
        if (row >= Set::kRows) continue;
        if (words[i]) bits[(int64_t)row * WORDS + lane] = 0u;
        n[i] = __reduce_add_sync(nnue::FULL, __popc(words[i]));
        if (n[i] > LIGHT) {
            heavy |= 1u << i;
        } else if (n[i]) {
            expand(words[i], light[w][i], (unsigned)l1, lane);
        }
    }
    if (heavy) {  // onto the list, one atomic a warp
        unsigned at = 0u;
        if (lane == 0) at = atomicAdd(list, (unsigned)__popc(heavy));
        at = __shfl_sync(nnue::FULL, at, 0);
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            if (!(heavy >> i & 1u)) continue;
            unsigned* e =
                list + LIST_HEAD + (int64_t)(at + __popc(heavy & ((1u << i) - 1u))) * ENTRY;
            if (lane == 0) *reinterpret_cast<uint4*>(e) = make_uint4(row0 + i, n[i], 0u, 0u);
            e[4 + lane] = words[i];
        }
    }
    __syncwarp();
    for (int c0 = 0; c0 < l1; c0 += 64) {  // columns c0 + lane and c0 + 32 + lane
        const int ca = c0 + lane, cb = ca + 32;
        float va[ROWS_PER_WARP][LIGHT], vb[ROWS_PER_WARP][LIGHT];
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
#pragma unroll
            for (int u = 0; u < LIGHT; ++u) {
                const int live = u < n[i] && n[i] <= LIGHT;
                const float* at = d_acc + (live ? light[w][i][u] : 0u);
                va[i][u] = load_if(at + ca, live && ca < l1);
                vb[i][u] = load_if(at + cb, live && cb < l1);
            }
        }
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const int row = row0 + i;
            if (row >= Set::kRows || n[i] > LIGHT || (!n[i] && !first)) continue;
            float* out = grad + (int64_t)row * l1;
            float sa = first || ca >= l1 ? 0.0f : out[ca];
            float sb = first || cb >= l1 ? 0.0f : out[cb];
#pragma unroll
            for (int u = 0; u < LIGHT; ++u) {
                const float ta = __fadd_rn(sa, va[i][u]), tb = __fadd_rn(sb, vb[i][u]);
                sa = u < n[i] ? ta : sa;
                sb = u < n[i] ? tb : sb;
            }
            if (ca < l1) out[ca] = sa;
            if (cb < l1) out[cb] = sb;
        }
    }
}

// The block's slice: columns c0..c0 + 31 of every pair (d_acc, rows of l1
// floats) into slice (rows of 32), a float4 a thread (8 a pair, vec4) or a
// float (32 a pair), a batch's loads all issued before its stores
template <int THREADS_>
__device__ __forceinline__ void load_slice(float* slice, const float* __restrict__ d_acc,
                                           int pairs, int l1, int c0, int vec4) {
    const int t = threadIdx.x;
    constexpr int LOADS = 16;
    if (vec4) {
        for (int base = 0; base < pairs * 8; base += LOADS * THREADS_) {
            float4 v[LOADS];
#pragma unroll
            for (int j = 0; j < LOADS; ++j) {
                const int i = base + j * THREADS_ + t, k = i >> 3, q = (i & 7) * 4;
                v[j] = load4_if(d_acc + (int64_t)min(k, pairs - 1) * l1 + c0 + q,
                                i < pairs * 8 && c0 + q < l1);
            }
#pragma unroll
            for (int j = 0; j < LOADS; ++j) {
                const int i = base + j * THREADS_ + t;
                if (i < pairs * 8) reinterpret_cast<float4*>(slice)[i] = v[j];
            }
        }
    } else {
        for (int base = 0; base < pairs * 32; base += LOADS * THREADS_) {
            float v[LOADS];
#pragma unroll
            for (int j = 0; j < LOADS; ++j) {
                const int i = base + j * THREADS_ + t, k = i >> 5, q = i & 31;
                v[j] = load_if(d_acc + (int64_t)min(k, pairs - 1) * l1 + c0 + q,
                               i < pairs * 32 && c0 + q < l1);
            }
#pragma unroll
            for (int j = 0; j < LOADS; ++j) {
                const int i = base + j * THREADS_ + t;
                if (i < pairs * 32) slice[i] = v[j];
            }
        }
    }
}

// 3. sums, over the window's `pairs` pairs (d_acc offset to it): block
// (slice, part); vec4: 16-byte loads (l1 and d_acc allow them)
template <class Set>
__global__ void __launch_bounds__(SUM_THREADS)
sums_kernel(const float* __restrict__ d_acc, unsigned* __restrict__ list,
            float* __restrict__ grad, int pairs, int l1, int first, int vec4) {
    extern __shared__ __align__(16) float slice[];  // (pairs + PAD) x 32: zero rows after the pairs
    unsigned* keys = reinterpret_cast<unsigned*>(slice + (pairs + PAD) * 32);
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int c0 = blockIdx.x * 32, c = c0 + lane;
    const float* col = slice + lane;
    let_next_start();
    for (int i = t; i < PAD * 32; i += SUM_THREADS) slice[pairs * 32 + i] = 0.0f;
    load_slice<SUM_THREADS>(slice, d_acc, pairs, l1, c0, vec4);
    __syncthreads();
    wait_for_previous();  // the row pass's list
    const int listed = (int)list[0];
    // entry e to block e % parts, warp e / parts: rows listed together
    // land on different SMs
    const int parts = gridDim.y, workers = parts * SUM_WARPS;
    unsigned* mine = keys + w * KEYS;
    for (int e = w * parts + blockIdx.y; e < listed; e += workers) {
        const unsigned* entry = list + LIST_HEAD + (int64_t)e * ENTRY;
        const int row = (int)entry[0], n = (int)entry[1];
        float* out = grad + (int64_t)row * l1 + c;
        float s = first || c >= l1 ? 0.0f : *out;
        expand(entry[4 + lane], mine, 32u, lane);
        const int padded = n <= SHORT ? SHORT : (n + 2 * AHEAD - 1) / (2 * AHEAD) * (2 * AHEAD);
        for (int i = n + lane; i < padded + 2 * AHEAD; i += 32) mine[i] = pairs * 32u;
        __syncwarp();
        if (n <= SHORT) {
            float v[SHORT];
#pragma unroll
            for (int u = 0; u < SHORT; ++u) v[u] = col[mine[u]];
#pragma unroll
            for (int u = 0; u < SHORT; ++u) s = __fadd_rn(s, v[u]);
        } else {
            s = smem_chain(col, mine, padded, s);
        }
        if (c < l1) *out = s;
        __syncwarp();
    }
    __syncthreads();  // the last block to finish empties the list
    if (t == 0) {
        __threadfence();
        if (atomicAdd(list + 1, 1u) == gridDim.x * gridDim.y - 1) {
            list[0] = 0u;
            list[1] = 0u;
        }
    }
}

// 4. ft_b, over the window's `pairs` pairs (d_acc offset to it): a block
// a 32-column slice, copied into shared memory, then one warp adds
template <class Set>
__global__ void __launch_bounds__(SUM_THREADS)
ftb_kernel(const float* __restrict__ d_acc, float* __restrict__ grad, int pairs, int l1,
           int first, int vec4) {
    extern __shared__ __align__(16) float slice[];  // (pairs + PAD) x 32: zero rows after the pairs
    const int t = threadIdx.x, lane = t & 31, c = blockIdx.x * 32 + lane;
    const float* col = slice + lane;
    let_next_start();
    for (int i = t; i < PAD * 32; i += SUM_THREADS) slice[pairs * 32 + i] = 0.0f;
    load_slice<SUM_THREADS>(slice, d_acc, pairs, l1, blockIdx.x * 32, vec4);
    __syncthreads();
    if (t >= 32) return;
    const int n = (pairs + 2 * AHEAD - 1) / (2 * AHEAD) * (2 * AHEAD);
    float* out = grad + (int64_t)Set::kRows * l1 + c;
    float s = first || c >= l1 ? 0.0f : *out;
    float a[AHEAD], b[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) a[u] = col[u * 32];
    for (int i = 0; i < n; i += 2 * AHEAD) {
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) b[u] = col[(i + AHEAD + u) * 32];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) s = __fadd_rn(s, a[u]);
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) a[u] = col[(i + 2 * AHEAD + u) * 32];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) s = __fadd_rn(s, b[u]);
    }
    if (c < l1) *out = s;
}

template <typename... Params, typename... Args>
cudaError_t launch_early(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                         cudaStream_t s, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The kernels' attributes, set once a device: the shared memory of the sum
// and ft_b passes, and for all four the same carveout, so the SMs need not
// switch between them.
template <class Set>
cudaError_t set_attributes() {
    constexpr int MAX_DEVICES = 64;
    static bool done[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return e;
    e = cudaFuncSetAttribute(sums_kernel<Set>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sum_smem(WINDOW));
    if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(ftb_kernel<Set>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 slice_smem(WINDOW));
    }
    for (const void* k : {(const void*)ftb_kernel<Set>, (const void*)mark_kernel<Set>,
                          (const void*)rows_kernel<Set>, (const void*)sums_kernel<Set>}) {
        if (e == cudaSuccess) {
            e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared);
        }
    }
    if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return e;
}

// The whole backward (stages 7), or its passes (1 mark, 2 rows, 4 sums and
// ft_b; for timing, over a batch of one window, each 1 followed by its 2,
// each 2 by its 4). scratch: zero; the bitmap (WORDS x Set::kRows words),
// then the list (LIST_HEAD words, an entry of ENTRY words a row).
template <class Set>
int ft_backward(const float* d_acc, const int32_t* boards, float* grad, unsigned* scratch,
                int batch, int l1, int stages, cudaStream_t s) {
    if (batch <= 0 || l1 <= 0 || stages < 1 || stages > 7) return (int)cudaErrorInvalidValue;
    const int slices = (l1 + 31) / 32;
    const int parts = std::max(1, 48 / slices);  // sum blocks a slice
    const int row_blocks = (Set::kRows + WARPS * ROWS_PER_WARP - 1) / (WARPS * ROWS_PER_WARP);
    const int vec4 = l1 % 4 == 0 && (uintptr_t)d_acc % 16 == 0;
    unsigned* list = scratch + (int64_t)WORDS * Set::kRows;
    cudaError_t e = set_attributes<Set>();
    for (int b0 = 0; b0 < batch && e == cudaSuccess; b0 += WINDOW_SAMPLES) {
        const int n = std::min(WINDOW_SAMPLES, batch - b0);
        const float* d = d_acc + (int64_t)2 * b0 * l1;
        const int first = b0 == 0;
        if (stages & 1) {
            const dim3 grid((n + MARK_SAMPLES - 1) / MARK_SAMPLES, 64 / WARPS);
            mark_kernel<Set><<<grid, THREADS, 0, s>>>(boards + (int64_t)b0 * 64, scratch, n);
        }
        if (stages & 2 && e == cudaSuccess) {
            e = launch_early(rows_kernel<Set>, dim3(row_blocks), THREADS, 0, s, d, scratch, list,
                             grad, l1, first);
        }
        if (stages & 4 && e == cudaSuccess) {
            e = launch_early(sums_kernel<Set>, dim3(slices, parts), SUM_THREADS,
                             sum_smem(2 * n), s, d, list, grad, 2 * n, l1, first, vec4);
        }
        if (stages & 4 && e == cudaSuccess) {
            e = launch_early(ftb_kernel<Set>, dim3(slices), SUM_THREADS, slice_smem(2 * n), s, d,
                             grad, 2 * n, l1, first, vec4);
        }
        if (e == cudaSuccess) e = cudaGetLastError();
    }
    return (int)e;
}

}  // namespace ftb
}  // namespace
