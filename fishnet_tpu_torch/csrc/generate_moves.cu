// K9 generate_moves: per lane, the pseudo-legal moves of the side to move
// (castling encoded king-takes-rook, its path checked for attacks),
// ordered as the search expands them — MVV-LVA captures and queen
// promotions first, then castling and killers, then quiet moves by their
// history counters — as MAX_MOVES moves padded with -1, with the count
// and the length of the noisy prefix. One instantiation per variant:
// horde's first-rank double pushes, atomic's kings that never capture,
// antichess's king promotions and capture compulsion, crazyhouse's drops
// and its MAX_MOVES_ZH-wide list (movegen.cuh).
//
// Replaces: fishnet_tpu/ops/movegen.py:124 generate_moves with :187
// _candidate_space (atomic's king captures :248-250, crazyhouse's drops
// :396-415) and the history and
// killer ordering (called every search step at
// fishnet_tpu/ops/search.py:463).
//
// Bound on the H100: bytes — per lane the 64 board codes, side to move, ep
// square, castling rooks and two killers in (288 B), one history word per
// quiet move, and the 224-word list and two counts out (904 B): ~1.2 KB a
// lane, 1.3 MB at 1024 lanes, ~0.4 us of HBM time (crazyhouse: its 10
// pocket words in and a 544-word list out, ~2.5 KB a lane). In practice
// each lane's dependent chain bounds it: the enumeration's steps, the
// history loads, and the sort's compare-exchange steps (21 in registers
// for up to 64 moves; for n longer, the 64-move blocks and log2(n / 64)
// merges of up to log2(n) steps).
//
// Design: one warp per lane, four lanes a block (movegen.cuh): the warp
// stages the board in shared memory, hands the side's pieces out as work
// units (a ray, a piece's targets, a pawn's moves) a thread each and
// appends their moves in lockstep by ballots, sets the keys with the
// history loads in flight, and sorts the packed values (registers up to
// 64, else the list's shared array). A warp keeps the list in shared
// memory where a thread per lane would keep it in local memory, and
// spreads the enumeration and the sort over 32 threads. The candidate
// space of the TPU version (4,962 fixed slots and a sort of all of them)
// is not carried over. The board fields, killers and history are views
// (a batch stride each, rows contiguous); killers and history may be
// absent (null).
#include "movegen.cuh"

namespace {

constexpr int LANES = 4;  // warps, one lane each, per block

template <int V>
__global__ void generate_moves_kernel(
        const int32_t* __restrict__ board, int64_t board_stride,
        const int32_t* __restrict__ stm, int64_t stm_stride,
        const int32_t* __restrict__ ep, int64_t ep_stride,
        const int32_t* __restrict__ castling, int64_t cast_stride,
        const int32_t* __restrict__ killers, int64_t killer_stride,
        const int32_t* __restrict__ hist, int64_t hist_stride,
        const int32_t* __restrict__ extra, int64_t extra_stride,
        int32_t* __restrict__ moves, int32_t* __restrict__ count, int32_t* __restrict__ noisy,
        int batch) {
    __shared__ int boards[LANES][64];
    __shared__ rules::MoveList<V> lists[LANES];
    const int w = threadIdx.x / rules::WARP, t = threadIdx.x % rules::WARP;
    const int lane = blockIdx.x * LANES + w;
    if (lane >= batch) return;
    rules::load_board(boards[w], board + lane * board_stride, t);
    rules::Ordering o;
    o.hist = hist != nullptr ? hist + lane * hist_stride : nullptr;
    o.killer0 = killers != nullptr ? killers[lane * killer_stride] : -1;
    o.killer1 = killers != nullptr ? killers[lane * killer_stride + 1] : -1;
    int n, nn;
    rules::generate_moves_warp<V>(boards[w], stm[lane * stm_stride], ep[lane * ep_stride],
                                  castling + lane * cast_stride,
                                  extra != nullptr ? extra + lane * extra_stride : nullptr, o,
                                  t, lists[w], moves + (int64_t)lane * rules::max_moves<V>(),
                                  &n, &nn);
    if (t == 0) {
        count[lane] = n;
        noisy[lane] = nn;
    }
}

}  // namespace

// strides in elements along the batch dimension (killers, hist, extra:
// row strides, rows contiguous; null for none, extra null but in
// crazyhouse); moves (batch, max_moves<V>()); count, noisy (batch,). One
// entry point per variant (kernels.py _variant_symbol).
#define GENERATE_MOVES_ENTRY(NAME, V)                                                        \
    FISHNET_EXPORT int NAME(const void* board, int64_t board_stride, const void* stm,       \
                            int64_t stm_stride, const void* ep, int64_t ep_stride,          \
                            const void* castling, int64_t cast_stride, const void* killers, \
                            int64_t killer_stride, const void* hist, int64_t hist_stride,   \
                            const void* extra, int64_t extra_stride, void* moves,           \
                            void* count, void* noisy, int batch, void* stream) {            \
        int grid = (batch + LANES - 1) / LANES;                                             \
        generate_moves_kernel<V><<<grid, LANES * rules::WARP, 0, (cudaStream_t)stream>>>(   \
            (const int32_t*)board, board_stride, (const int32_t*)stm, stm_stride,           \
            (const int32_t*)ep, ep_stride, (const int32_t*)castling, cast_stride,           \
            (const int32_t*)killers, killer_stride, (const int32_t*)hist, hist_stride,      \
            (const int32_t*)extra, extra_stride, (int32_t*)moves, (int32_t*)count,          \
            (int32_t*)noisy, batch);                                                        \
        return (int)cudaGetLastError();                                                     \
    }

GENERATE_MOVES_ENTRY(generate_moves, rules::VARIANT_STANDARD)
GENERATE_MOVES_ENTRY(generate_moves_threeCheck, rules::VARIANT_THREECHECK)
GENERATE_MOVES_ENTRY(generate_moves_crazyhouse, rules::VARIANT_CRAZYHOUSE)
GENERATE_MOVES_ENTRY(generate_moves_antichess, rules::VARIANT_ANTICHESS)
GENERATE_MOVES_ENTRY(generate_moves_atomic, rules::VARIANT_ATOMIC)
GENERATE_MOVES_ENTRY(generate_moves_horde, rules::VARIANT_HORDE)
GENERATE_MOVES_ENTRY(generate_moves_kingOfTheHill, rules::VARIANT_KINGOFTHEHILL)
GENERATE_MOVES_ENTRY(generate_moves_racingKings, rules::VARIANT_RACINGKINGS)
