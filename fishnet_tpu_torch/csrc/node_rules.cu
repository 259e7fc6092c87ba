// K8 node_rules: per lane, whether the move that led to the position was
// illegal (the mover's king missing or attacked, or the variant's own
// duty broken), whether the side to move is in check, and the variant's
// game end at the node (TERM_*), for standard chess and chess960 and, one
// instantiation each, threeCheck, kingOfTheHill, racingKings, horde,
// atomic (adjacent kings, an exploded king), antichess and crazyhouse
// (whose rules are standard chess's: its instantiation takes no variant
// branch).
//
// Replaces: fishnet_tpu/ops/board.py:256 node_rules with :137 attack_map
// and its variant branches (atomic's :292-305; called every search step
// at fishnet_tpu/ops/search.py:377).
//
// Bound on the H100: bytes — per lane the 64 board codes and the side to
// move in (260 B; threeCheck also two counters), two flags and the kind
// out; 0.27 MB at 1024 lanes, ~0.08 us of HBM time, so the launch and the
// dependent shared-memory reads of the ray walks (a few hundred cycles)
// dominate.
//
// Design: one warp per lane, four lanes a block. The warp stages the
// board in shared memory; the threads that hold a king square walk its
// attack lines (board.cuh attacked: eight rays, knight, king and pawn
// squares) instead of building the plain version's two whole-board attack
// maps, and warp votes combine them. The board, side to move and variant
// words are views of the search's packed rows (a batch stride, rows
// contiguous); the variant words may be absent (null) but in threeCheck.
#include "board.cuh"

namespace {

constexpr int LANES = 4;  // warps, one lane each, per block

template <int V>
__global__ void node_rules_kernel(const int32_t* __restrict__ board, int64_t board_stride,
                                  const int32_t* __restrict__ stm, int64_t stm_stride,
                                  const int32_t* __restrict__ extra, int64_t extra_stride,
                                  bool* __restrict__ illegal, bool* __restrict__ checked,
                                  int32_t* __restrict__ term, int batch) {
    __shared__ int boards[LANES][64];
    const int w = threadIdx.x / rules::WARP, t = threadIdx.x % rules::WARP;
    const int lane = blockIdx.x * LANES + w;
    if (lane >= batch) return;
    rules::load_board(boards[w], board + lane * board_stride, t);
    bool ill, chk;
    int kind;
    rules::node_rules_warp<V>(boards[w], stm[lane * stm_stride],
                              extra != nullptr ? extra + lane * extra_stride : nullptr, t, &ill,
                              &chk, &kind);
    if (t == 0) {
        illegal[lane] = ill;
        checked[lane] = chk;
        term[lane] = kind;
    }
}

template <int V>
int launch(const void* board, int64_t board_stride, const void* stm, int64_t stm_stride,
           const void* extra, int64_t extra_stride, void* illegal, void* checked, void* term,
           int batch, void* stream) {
    int grid = (batch + LANES - 1) / LANES;
    node_rules_kernel<V><<<grid, LANES * rules::WARP, 0, (cudaStream_t)stream>>>(
        (const int32_t*)board, board_stride, (const int32_t*)stm, stm_stride,
        (const int32_t*)extra, extra_stride, (bool*)illegal, (bool*)checked, (int32_t*)term,
        batch);
    return (int)cudaGetLastError();
}

}  // namespace

// strides in elements along the batch dimension; extra (batch, 12) rows
// or null; illegal, checked (batch,) bool; term (batch,) int32. One entry
// point per variant (kernels.py _variant_symbol).
#define NODE_RULES_ENTRY(NAME, V)                                                           \
    FISHNET_EXPORT int NAME(const void* board, int64_t board_stride, const void* stm,      \
                            int64_t stm_stride, const void* extra, int64_t extra_stride,   \
                            void* illegal, void* checked, void* term, int batch,           \
                            void* stream) {                                                \
        return launch<V>(board, board_stride, stm, stm_stride, extra, extra_stride,        \
                         illegal, checked, term, batch, stream);                           \
    }

NODE_RULES_ENTRY(node_rules, rules::VARIANT_STANDARD)
NODE_RULES_ENTRY(node_rules_threeCheck, rules::VARIANT_THREECHECK)
NODE_RULES_ENTRY(node_rules_crazyhouse, rules::VARIANT_CRAZYHOUSE)
NODE_RULES_ENTRY(node_rules_antichess, rules::VARIANT_ANTICHESS)
NODE_RULES_ENTRY(node_rules_atomic, rules::VARIANT_ATOMIC)
NODE_RULES_ENTRY(node_rules_horde, rules::VARIANT_HORDE)
NODE_RULES_ENTRY(node_rules_kingOfTheHill, rules::VARIANT_KINGOFTHEHILL)
NODE_RULES_ENTRY(node_rules_racingKings, rules::VARIANT_RACINGKINGS)
