// K8 node_rules: per lane, whether the move that led to the position was
// illegal (the mover's king missing or attacked) and whether the side to
// move is in check, for standard chess and chess960.
//
// Replaces: fishnet_tpu/ops/board.py:256 node_rules with :137 attack_map
// (called every search step at fishnet_tpu/ops/search.py:377).
//
// Bound on the H100: bytes — per lane the 64 board codes and the side to
// move in (260 B), two flags out; 0.27 MB at 1024 lanes, ~0.08 us of HBM
// time, so the launch and the dependent shared-memory reads of the ray
// walks (a few hundred cycles) dominate.
//
// Design: one warp per lane, four lanes a block. The warp stages the
// board in shared memory; the threads that hold a king square walk its
// attack lines (board.cuh attacked: eight rays, knight, king and pawn
// squares) instead of building the plain version's two whole-board attack
// maps, and warp votes combine them. The board and side to move are
// views of the search's packed rows (a batch stride, rows contiguous).
#include "board.cuh"

namespace {

constexpr int LANES = 4;  // warps, one lane each, per block

__global__ void node_rules_kernel(const int32_t* __restrict__ board, int64_t board_stride,
                                  const int32_t* __restrict__ stm, int64_t stm_stride,
                                  bool* __restrict__ illegal, bool* __restrict__ checked,
                                  int batch) {
    __shared__ int boards[LANES][64];
    const int w = threadIdx.x / rules::WARP, t = threadIdx.x % rules::WARP;
    const int lane = blockIdx.x * LANES + w;
    if (lane >= batch) return;
    rules::load_board(boards[w], board + lane * board_stride, t);
    bool ill, chk;
    rules::node_rules_warp(boards[w], stm[lane * stm_stride], t, &ill, &chk);
    if (t == 0) {
        illegal[lane] = ill;
        checked[lane] = chk;
    }
}

}  // namespace

// strides in elements along the batch dimension; illegal, checked (batch,)
FISHNET_EXPORT int node_rules(const void* board, int64_t board_stride, const void* stm,
                              int64_t stm_stride, void* illegal, void* checked, int batch,
                              void* stream) {
    int grid = (batch + LANES - 1) / LANES;
    node_rules_kernel<<<grid, LANES * rules::WARP, 0, (cudaStream_t)stream>>>(
        (const int32_t*)board, board_stride, (const int32_t*)stm, stm_stride, (bool*)illegal,
        (bool*)checked, batch);
    return (int)cudaGetLastError();
}
