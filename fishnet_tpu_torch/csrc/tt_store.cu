// K6 tt_store: store one transposition-table entry per masked lane, in
// place, with a defined winner where lanes collide on a slot.
//
// Replaces: fishnet_tpu/ops/tt.py:240 store, plain and prefer_deep
// (called twice per search step by the runner at
// fishnet_tpu/ops/search.py:933 and :976). The reference writes all lanes
// with one row scatter; on XLA:CPU the highest storable lane of a slot
// wins and its row lands whole. A plain CUDA scatter would race and could
// tear rows (four words from different lanes), so the store makes the
// rule explicit. With prefer_deep every lane's keep-old decision reads
// the pre-store table, as in the reference.
//
// Bound on the H100: latency. Per lane 6 int32 inputs, a mask and one
// 16-byte row out (plus one 16-byte row read with prefer_deep): ~45 KB
// at B = 1024, ~0.01 us of HBM time; two dependent launches of one
// table round trip each set the time.
//
// Design: the store body of tt.cuh that K11 runs for its stores, here as
// two launches in stream order, one thread a lane, 128 lanes a block: the
// claim half (each lane decides against the pre-store row, stages its row
// and slot in the launch's scratch and takes the slot's claim word with
// atomicMax of its index), then the commit half (each slot's highest
// claiming lane writes its row with one int4 store and frees the word).
// The claim words are the caller's stream's, all -1 between stores (K11's
// interior store's; the keep-old read goes through the leaf store's,
// which are free here, so it reads the table as K11's own store does).
// O(B) work on any number of blocks; lanes that narrowing compacts keep
// their relative order, so the rule gives the reference's table through
// narrowing too.
#include "tt.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int STAGED = 2;  // int4s of scratch a lane: its row, its slot

__global__ void claim_kernel(const int4* __restrict__ table, uint32_t nmask,
                             const int32_t* __restrict__ h1, int64_t s_h1,
                             const int32_t* __restrict__ h2, int64_t s_h2,
                             const int32_t* __restrict__ score, int64_t s_sc,
                             const int32_t* __restrict__ depth, int64_t s_d,
                             const int32_t* __restrict__ flag, int64_t s_f,
                             const int32_t* __restrict__ move, int64_t s_m,
                             const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ gen_lanes, int gen, int prefer_deep,
                             tt::Pending mine, tt::Pending other, int batch) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= batch) return;
    const uint32_t key = (uint32_t)h1[i * s_h1];
    const int32_t d = depth[i * s_d], g = gen_lanes ? gen_lanes[i] : gen;
    tt::store_claim(mine, nmask, i, mask[i] != 0, key, h2[i * s_h2], score[i * s_sc], d,
                    flag[i * s_f], move[i * s_m], g, prefer_deep != 0, [&] {
                        bool through;
                        return tt::keep_old(tt::read_row(table, other, key & nmask, through), g,
                                            d);
                    });
}

__global__ void commit_kernel(int4* __restrict__ table, tt::Pending mine, int batch) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < batch) tt::store_commit(table, mine, i);
}

}  // namespace

// table (n, 4) int32 with n a power of two, updated in place; strides in
// elements; mask (batch,) bool; gen_lanes (batch,) int32 or null (then
// every lane stores generation `gen`); claims (2, n) int32, all -1, left
// so; scratch (batch, 8) int32
FISHNET_EXPORT int tt_store(void* table, int n,
                            const void* h1, int64_t s_h1, const void* h2, int64_t s_h2,
                            const void* score, int64_t s_sc, const void* depth, int64_t s_d,
                            const void* flag, int64_t s_f, const void* move, int64_t s_m,
                            const void* mask, const void* gen_lanes, int gen,
                            int prefer_deep, void* claims, void* scratch, int batch,
                            void* stream) {
    const int grid = (batch + THREADS - 1) / THREADS;
    const tt::Pending mine{(int*)claims, (int4*)scratch, STAGED};
    const tt::Pending other{(int*)claims + n, (int4*)scratch, STAGED};
    claim_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)table, (uint32_t)n - 1u, (const int32_t*)h1, s_h1,
        (const int32_t*)h2, s_h2, (const int32_t*)score, s_sc,
        (const int32_t*)depth, s_d, (const int32_t*)flag, s_f,
        (const int32_t*)move, s_m, (const uint8_t*)mask,
        (const int32_t*)gen_lanes, gen, prefer_deep, mine, other, batch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    commit_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((int4*)table, mine, batch);
    return (int)cudaGetLastError();
}
