// K5 tt_probe: one transposition-table probe per lane. Each lane reads
// its slot's 16-byte row (check, meta, move, generation), validates it
// against the second key, and decides whether the stored bound cuts the
// window the lane's node is about to be searched with.
//
// Replaces: fishnet_tpu/ops/tt.py:188 probe (called once per search step
// by the runner at fishnet_tpu/ops/search.py:966, with `usable &= enter`
// and the ordering move masked to entering lanes, which this kernel
// folds in).
//
// Bound on the H100: bytes, and latency before that. Per lane 5 int32
// inputs and the enter flag in (21 B), one random 16-byte table row
// (one 32-byte sector), and 9 B out. At B = 1024 that is ~47 KB, ~0.01 us
// of HBM time, so the launch and one dependent DRAM round trip set the
// time.
//
// Design: one thread per lane, 128 lanes a block, each running tt.cuh
// probe_row (the body K11 calls too); the row is one int4 load (the table
// is 16-byte aligned, rows are 16 bytes). Slot = h1 &
// (n - 1) on uint32 bits. A row is valid when check ^ meta ^ move == h2
// and meta != 0; score/depth/flag unpack from meta with the reference's
// arithmetic shifts, so every output equals the plain version's bits.
// The (B,) int32 inputs take an element stride, so the runner passes
// columns of its lane table and of the hash output without copying.
#include "tt.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void probe_kernel(const int4* __restrict__ table, uint32_t nmask,
                             const int32_t* __restrict__ h1, int64_t s_h1,
                             const int32_t* __restrict__ h2, int64_t s_h2,
                             const int32_t* __restrict__ depth_left, int64_t s_dl,
                             const int32_t* __restrict__ alpha, int64_t s_a,
                             const int32_t* __restrict__ beta, int64_t s_b,
                             const uint8_t* __restrict__ enter, int deep_bounds,
                             uint8_t* __restrict__ usable, int32_t* __restrict__ score,
                             int32_t* __restrict__ order_move, int batch) {
    int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= batch) return;
    uint32_t slot = (uint32_t)h1[lane * s_h1] & nmask;
    bool use;
    tt::probe_row(table[slot], h2[lane * s_h2], depth_left[lane * s_dl], alpha[lane * s_a],
                  beta[lane * s_b], enter[lane] != 0, deep_bounds != 0, use, score[lane],
                  order_move[lane]);
    usable[lane] = use ? 1 : 0;
}

}  // namespace

// table (n, 4) int32 with n a power of two; strides in elements; enter,
// usable (batch,) bool; score, order_move (batch,) int32
FISHNET_EXPORT int tt_probe(const void* table, int n,
                            const void* h1, int64_t s_h1, const void* h2, int64_t s_h2,
                            const void* depth_left, int64_t s_dl,
                            const void* alpha, int64_t s_a, const void* beta, int64_t s_b,
                            const void* enter, int deep_bounds, void* usable, void* score,
                            void* order_move, int batch, void* stream) {
    int grid = (batch + THREADS - 1) / THREADS;
    probe_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)table, (uint32_t)n - 1u, (const int32_t*)h1, s_h1,
        (const int32_t*)h2, s_h2, (const int32_t*)depth_left, s_dl,
        (const int32_t*)alpha, s_a, (const int32_t*)beta, s_b,
        (const uint8_t*)enter, deep_bounds, (uint8_t*)usable, (int32_t*)score,
        (int32_t*)order_move, batch);
    return (int)cudaGetLastError();
}
