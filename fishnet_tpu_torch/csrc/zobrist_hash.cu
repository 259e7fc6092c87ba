// K4 zobrist_hash: the two 32-bit Zobrist keys of a position — XOR of the
// piece-square keys of every occupied square, the en-passant key, the
// four castling-slot keys and the side-to-move key, under the two tables
// Z1 and Z2; one instantiation per variant, each but standard chess's
// adding its salt (atomic's is all it adds), threeCheck its check
// counters, crazyhouse its ten pocket counts and the keys of its
// promoted-piece bits.
//
// Replaces: fishnet_tpu/ops/tt.py:113 hash_board with its variant keys
// (:151-171; called every search step at fishnet_tpu/ops/search.py:397
// for the repetition scan, and once per chunk over the game history at
// fishnet_tpu/engine/tpu.py:766).
//
// Bound on the H100: bytes — per lane 64 board words plus 6 scalars in
// (280 B; threeCheck also its two counters, crazyhouse its 12 words) and
// 8 B out. Of each 1,409-key table it reads the first 1,159:
// piece-square, ep, castling and stm, 2 x 4.6 KB that stay in L1, and a
// variant's salt, counter, pocket and promoted keys from its tail. At B = 1024 that is 0.3 MB, ~0.1 us of HBM time, so
// the launch dominates.
//
// Design: one thread per lane, 128 lanes a block, each running tt.cuh
// zobrist_keys (the segment kernel K11 folds the same keys over a warp);
// the XOR fold is order free, so the keys equal the reference's bit for
// bit. The board, stm, ep
// and castling arguments take a row stride, so the search passes views of
// its packed board rows without copying them. Keys are carried as int32
// bit patterns (torch has few uint32 operators; XOR is the same bits).
#include "tt.cuh"

namespace {

constexpr int THREADS = 128;

template <int V>
__global__ void hash_kernel(const int32_t* __restrict__ board, int64_t board_stride,
                            const int32_t* __restrict__ stm, int64_t stm_stride,
                            const int32_t* __restrict__ ep, int64_t ep_stride,
                            const int32_t* __restrict__ castling, int64_t cast_stride,
                            const int32_t* __restrict__ extra, int64_t extra_stride,
                            const uint32_t* __restrict__ z1,
                            const uint32_t* __restrict__ z2,
                            uint32_t* __restrict__ out, int batch) {
    int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= batch) return;
    uint32_t h1, h2;
    tt::zobrist_keys<V>(board + lane * board_stride, stm[lane * stm_stride],
                        ep[lane * ep_stride], castling + lane * cast_stride,
                        extra != nullptr ? extra + lane * extra_stride : nullptr, z1, z2, h1,
                        h2);
    out[lane * 2] = h1;
    out[lane * 2 + 1] = h2;
}

}  // namespace

// strides in elements along the batch dimension; extra (batch, 12) rows,
// or null but in threeCheck and crazyhouse; out (batch, 2). One entry point per variant
// (kernels.py _variant_symbol).
#define ZOBRIST_ENTRY(NAME, V)                                                              \
    FISHNET_EXPORT int NAME(const void* board, int64_t board_stride, const void* stm,      \
                            int64_t stm_stride, const void* ep, int64_t ep_stride,         \
                            const void* castling, int64_t cast_stride, const void* extra,  \
                            int64_t extra_stride, const void* z1, const void* z2,          \
                            void* out, int batch, void* stream) {                          \
        int grid = (batch + THREADS - 1) / THREADS;                                        \
        hash_kernel<V><<<grid, THREADS, 0, (cudaStream_t)stream>>>(                        \
            (const int32_t*)board, board_stride, (const int32_t*)stm, stm_stride,          \
            (const int32_t*)ep, ep_stride, (const int32_t*)castling, cast_stride,          \
            (const int32_t*)extra, extra_stride, (const uint32_t*)z1, (const uint32_t*)z2, \
            (uint32_t*)out, batch);                                                        \
        return (int)cudaGetLastError();                                                    \
    }

ZOBRIST_ENTRY(zobrist_hash, consts::VARIANT_STANDARD)
ZOBRIST_ENTRY(zobrist_hash_threeCheck, consts::VARIANT_THREECHECK)
ZOBRIST_ENTRY(zobrist_hash_crazyhouse, consts::VARIANT_CRAZYHOUSE)
ZOBRIST_ENTRY(zobrist_hash_antichess, consts::VARIANT_ANTICHESS)
ZOBRIST_ENTRY(zobrist_hash_atomic, consts::VARIANT_ATOMIC)
ZOBRIST_ENTRY(zobrist_hash_horde, consts::VARIANT_HORDE)
ZOBRIST_ENTRY(zobrist_hash_kingOfTheHill, consts::VARIANT_KINGOFTHEHILL)
ZOBRIST_ENTRY(zobrist_hash_racingKings, consts::VARIANT_RACINGKINGS)
