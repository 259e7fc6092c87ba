// K4 zobrist_hash: the two 32-bit Zobrist keys of a standard-chess
// position — XOR of the piece-square keys of every occupied square, the
// en-passant key, the four castling-slot keys and the side-to-move key,
// under the two tables Z1 and Z2.
//
// Replaces: fishnet_tpu/ops/tt.py:113 hash_board (called every search
// step at fishnet_tpu/ops/search.py:397 for the repetition scan, and once
// per chunk over the game history at fishnet_tpu/engine/tpu.py:766).
//
// Bound on the H100: bytes — per lane 64 board words plus 6 scalars in
// (280 B) and 8 B out. Of each 1,409-key table (its tail holds the variant
// keys) it reads the first 1,159: piece-square, ep, castling and stm, 2 x
// 4.6 KB that stay in L1. At B = 1024 that is 0.3 MB, ~0.1 us of HBM time,
// so the launch dominates.
//
// Design: one thread per lane, 128 lanes a block; the XOR fold is order
// free, so the keys equal the reference's bit for bit. The board, stm, ep
// and castling arguments take a row stride, so the search passes views of
// its packed board rows without copying them. Keys are carried as int32
// bit patterns (torch has few uint32 operators; XOR is the same bits).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int EP_OFF = 13 * 64;
constexpr int CASTLE_OFF = EP_OFF + 65;
constexpr int STM_OFF = CASTLE_OFF + 4 * 65;

__global__ void hash_kernel(const int32_t* __restrict__ board, int64_t board_stride,
                            const int32_t* __restrict__ stm, int64_t stm_stride,
                            const int32_t* __restrict__ ep, int64_t ep_stride,
                            const int32_t* __restrict__ castling, int64_t cast_stride,
                            const uint32_t* __restrict__ z1,
                            const uint32_t* __restrict__ z2,
                            uint32_t* __restrict__ out, int batch) {
    int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= batch) return;
    const int32_t* bd = board + lane * board_stride;
    uint32_t h1 = 0, h2 = 0;
    for (int sq = 0; sq < 64; ++sq) {
        int code = bd[sq];
        if (code > 0 && code <= 12) {
            h1 ^= z1[code * 64 + sq];
            h2 ^= z2[code * 64 + sq];
        }
    }
    int e = ep[lane * ep_stride] + 1;
    if (e >= 0 && e < 65) {
        h1 ^= z1[EP_OFF + e];
        h2 ^= z2[EP_OFF + e];
    }
    const int32_t* cs = castling + lane * cast_stride;
    for (int i = 0; i < 4; ++i) {
        int c = cs[i] + 1;
        if (c >= 0 && c < 65) {
            h1 ^= z1[CASTLE_OFF + i * 65 + c];
            h2 ^= z2[CASTLE_OFF + i * 65 + c];
        }
    }
    int s = stm[lane * stm_stride] == 0 ? 0 : 1;
    h1 ^= z1[STM_OFF + s];
    h2 ^= z2[STM_OFF + s];
    out[lane * 2] = h1;
    out[lane * 2 + 1] = h2;
}

}  // namespace

// strides in elements along the batch dimension; out (batch, 2)
FISHNET_EXPORT int zobrist_hash(const void* board, int64_t board_stride,
                                const void* stm, int64_t stm_stride,
                                const void* ep, int64_t ep_stride,
                                const void* castling, int64_t cast_stride,
                                const void* z1, const void* z2, void* out,
                                int batch, void* stream) {
    int grid = (batch + THREADS - 1) / THREADS;
    hash_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)board, board_stride, (const int32_t*)stm, stm_stride,
        (const int32_t*)ep, ep_stride, (const int32_t*)castling, cast_stride,
        (const uint32_t*)z1, (const uint32_t*)z2, (uint32_t*)out, batch);
    return (int)cudaGetLastError();
}
