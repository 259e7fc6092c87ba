// K10 make_move: per lane, the child of one move (from | to<<6 |
// promo<<12; castling encoded king-takes-rook, chess960 too) as a packed
// board row, and the four piece-change slots the accumulator update (K3)
// reads: [mover out, capture out, mover in, rook in], as codes, squares
// and signs. One instantiation per variant: horde's back-rank double
// pushes set no ep square, threeCheck counts the mover's checks in the
// variant words the child copies from its parent, crazyhouse drops pieces
// from the pockets (DROP_FLAG | type<<12 | to<<6 | to: one change slot),
// fills the capturer's pocket and moves the promoted-piece bits; an atomic
// capture explodes the capturer and every non-pawn a king step around the
// landing square, with the castling rights of the rooks and kings it takes.
//
// Replaces: fishnet_tpu/ops/board.py:345 make_move and :516
// move_piece_changes, sharing the decode as the port's
// make_move_with_changes does, with crazyhouse's branches (:359-392,
// :469-504, :528-565) and atomic's explosion (:424-456; called every
// search step at fishnet_tpu/ops/search.py:749 and :802).
//
// Bound on the H100: bytes — per lane the parent's 64 codes and its side
// to move, ep square, castling rooks, halfmove clock and 12 variant words
// plus the move in (336 B), the 96-word child row and 12 change words out
// (432 B); 0.79 MB at 1024 lanes, ~0.24 us of HBM time.
//
// Design: one warp per lane, four lanes a block. The warp stages the
// parent board in shared memory; every thread decodes the move (a few
// reads of that board and the generated tables) and writes its own words
// of the child row — two squares and one scalar word each, so the row is
// written with coalesced stores and no thread waits on another. The parent
// fields are views of the search's packed rows (a batch stride each).
#include "board.cuh"

namespace {

constexpr int LANES = 4;  // warps, one lane each, per block

template <int V>
__global__ void make_move_kernel(
        const int32_t* __restrict__ board, int64_t board_stride,
        const int32_t* __restrict__ stm, int64_t stm_stride,
        const int32_t* __restrict__ ep, int64_t ep_stride,
        const int32_t* __restrict__ castling, int64_t cast_stride,
        const int32_t* __restrict__ halfmove, int64_t hm_stride,
        const int32_t* __restrict__ extra, int64_t extra_stride,
        const int32_t* __restrict__ move, int64_t move_stride,
        int32_t* __restrict__ child, int32_t* __restrict__ codes, int32_t* __restrict__ sqs,
        int32_t* __restrict__ signs, int batch) {
    __shared__ int boards[LANES][64];
    const int w = threadIdx.x / rules::WARP, t = threadIdx.x % rules::WARP;
    const int lane = blockIdx.x * LANES + w;
    if (lane >= batch) return;
    rules::load_board(boards[w], board + lane * board_stride, t);
    rules::make_move_warp<V>(boards[w], stm[lane * stm_stride], ep[lane * ep_stride],
                             castling + lane * cast_stride, halfmove[lane * hm_stride],
                             extra + lane * extra_stride, move[lane * move_stride], t,
                             child + (int64_t)lane * rules::BT_W, codes + lane * 4,
                             sqs + lane * 4, signs + lane * 4);
}

}  // namespace

// strides in elements along the batch dimension; extra (batch, 12) rows;
// child (batch, BT_W); codes, sqs, signs (batch, 4). One entry point per
// variant (kernels.py _variant_symbol).
#define MAKE_MOVE_ENTRY(NAME, V)                                                            \
    FISHNET_EXPORT int NAME(const void* board, int64_t board_stride, const void* stm,      \
                            int64_t stm_stride, const void* ep, int64_t ep_stride,         \
                            const void* castling, int64_t cast_stride,                     \
                            const void* halfmove, int64_t hm_stride, const void* extra,    \
                            int64_t extra_stride, const void* move, int64_t move_stride,   \
                            void* child, void* codes, void* sqs, void* signs, int batch,   \
                            void* stream) {                                                \
        int grid = (batch + LANES - 1) / LANES;                                            \
        make_move_kernel<V><<<grid, LANES * rules::WARP, 0, (cudaStream_t)stream>>>(       \
            (const int32_t*)board, board_stride, (const int32_t*)stm, stm_stride,          \
            (const int32_t*)ep, ep_stride, (const int32_t*)castling, cast_stride,          \
            (const int32_t*)halfmove, hm_stride, (const int32_t*)extra, extra_stride,      \
            (const int32_t*)move, move_stride, (int32_t*)child, (int32_t*)codes,           \
            (int32_t*)sqs, (int32_t*)signs, batch);                                        \
        return (int)cudaGetLastError();                                                    \
    }

MAKE_MOVE_ENTRY(make_move, rules::VARIANT_STANDARD)
MAKE_MOVE_ENTRY(make_move_threeCheck, rules::VARIANT_THREECHECK)
MAKE_MOVE_ENTRY(make_move_crazyhouse, rules::VARIANT_CRAZYHOUSE)
MAKE_MOVE_ENTRY(make_move_antichess, rules::VARIANT_ANTICHESS)
MAKE_MOVE_ENTRY(make_move_atomic, rules::VARIANT_ATOMIC)
MAKE_MOVE_ENTRY(make_move_horde, rules::VARIANT_HORDE)
MAKE_MOVE_ENTRY(make_move_kingOfTheHill, rules::VARIANT_KINGOFTHEHILL)
MAKE_MOVE_ENTRY(make_move_racingKings, rules::VARIANT_RACINGKINGS)
