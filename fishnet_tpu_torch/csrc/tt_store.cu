// K6 tt_store: store one transposition-table entry per masked lane, in
// place, with a defined winner where lanes collide on a slot.
//
// Replaces: fishnet_tpu/ops/tt.py:240 store, plain and prefer_deep
// (called twice per search step by the runner at
// fishnet_tpu/ops/search.py:933 and :976). The reference writes all lanes
// with one row scatter; on XLA:CPU the highest storable lane of a slot
// wins and its row lands whole. A plain CUDA scatter would race and could
// tear rows (four words from different lanes), so this kernel makes the
// rule explicit: a storable lane writes only if no higher storable lane
// has the same slot. With prefer_deep every lane's keep-old decision
// reads the pre-store table, as in the reference.
//
// Bound on the H100: latency. Per lane 6 int32 inputs, a mask and one
// 16-byte row out (plus one 16-byte row read with prefer_deep): ~45 KB
// at B = 1024, ~0.01 us of HBM time. The winner scan is O(B^2) compares
// in shared memory (at most 1M at B = 1024, a few microseconds), and one
// block runs it, which is fine while the step launches ~700 kernels.
//
// Design: one block of up to 1024 threads (the row and the keep-old rule
// are tt.cuh's, which K11 shares; K11 resolves collisions across blocks
// with per-slot claims instead of this scan); each thread walks lanes i,
// i + blockDim, ... Phase 1 reads every old row it needs and writes the
// lane's effective slot (-1: stores nothing) to shared memory; after
// __syncthreads no thread reads the table again, so the keep-old
// decisions all see the pre-store rows. Phase 2 scans the higher lanes'
// slots and lets only the last lane of each slot write its row with one
// int4 store. Lanes narrowing compacts keep their relative order, so the
// rule gives the reference's table through narrowing too.
#include "tt.cuh"

namespace {

constexpr int MAX_LANES = 8192;  // 32 KB of shared slots

__global__ void store_kernel(int4* __restrict__ table, uint32_t nmask,
                             const int32_t* __restrict__ h1, int64_t s_h1,
                             const int32_t* __restrict__ h2, int64_t s_h2,
                             const int32_t* __restrict__ score, int64_t s_sc,
                             const int32_t* __restrict__ depth, int64_t s_d,
                             const int32_t* __restrict__ flag, int64_t s_f,
                             const int32_t* __restrict__ move, int64_t s_m,
                             const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ gen_lanes, int gen,
                             int prefer_deep, int batch) {
    __shared__ int eff[MAX_LANES];
    for (int i = threadIdx.x; i < batch; i += blockDim.x) {
        int slot = -1;
        if (mask[i] && tt::storable(score[i * s_sc])) {
            uint32_t s = (uint32_t)h1[i * s_h1] & nmask;
            int32_t g = gen_lanes ? gen_lanes[i] : gen;
            if (!(prefer_deep && tt::keep_old(table[s], g, depth[i * s_d]))) slot = (int)s;
        }
        eff[i] = slot;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < batch; i += blockDim.x) {
        int slot = eff[i];
        if (slot < 0) continue;
        bool last = true;
        for (int j = i + 1; j < batch; ++j) {
            if (eff[j] == slot) {
                last = false;
                break;
            }
        }
        if (!last) continue;
        table[slot] = tt::store_row(h2[i * s_h2], score[i * s_sc], depth[i * s_d],
                                    flag[i * s_f], move[i * s_m],
                                    gen_lanes ? gen_lanes[i] : gen);
    }
}

}  // namespace

// table (n, 4) int32 with n a power of two, updated in place; strides in
// elements; mask (batch,) bool; gen_lanes (batch,) int32 or null (then
// every lane stores generation `gen`); batch <= 8192
FISHNET_EXPORT int tt_store(void* table, int n,
                            const void* h1, int64_t s_h1, const void* h2, int64_t s_h2,
                            const void* score, int64_t s_sc, const void* depth, int64_t s_d,
                            const void* flag, int64_t s_f, const void* move, int64_t s_m,
                            const void* mask, const void* gen_lanes, int gen,
                            int prefer_deep, int batch, void* stream) {
    if (batch > MAX_LANES) return (int)cudaErrorInvalidValue;
    int threads = batch < 1024 ? ((batch + 31) / 32) * 32 : 1024;
    store_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
        (int4*)table, (uint32_t)n - 1u, (const int32_t*)h1, s_h1,
        (const int32_t*)h2, s_h2, (const int32_t*)score, s_sc,
        (const int32_t*)depth, s_d, (const int32_t*)flag, s_f,
        (const int32_t*)move, s_m, (const uint8_t*)mask,
        (const int32_t*)gen_lanes, gen, prefer_deep, batch);
    return (int)cudaGetLastError();
}
