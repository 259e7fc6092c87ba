// K7 lane_init: (re)initialise listed lanes of a running search state in
// place, with the values init_state gives a fresh root: the board stack
// (row 0 the root, the rest empty with no ep square and no castling
// rooks), the per-node scalars, the lane scalars (depth, budget, root
// window, jitter, group), the game-history seeds, empty move lists and
// PV table, the history counters (the helper-jitter mix), and the NNUE
// accumulator stack (row 0 the root's, computed by K1; the rest zero).
// Lanes not listed are not touched.
//
// Replaces: fishnet_tpu/ops/search.py:236 init_state (all but the root
// accumulator refresh, which is K1) and :1061 _merge_lanes with
// _refill_fresh's row gather (:1095): the reference builds a full-width
// fresh state and selects it into the listed lanes; this kernel writes
// the listed lanes directly, so a refill boundary allocates nothing big.
//
// Bound on the H100: bytes. At MAX_PLY 32 one lane writes ~81 KB (moves
// 28,672 B, history 16,384 B, accumulators 16,896 B, boards 12,672 B,
// PV 4,096 B, node scalars 2,112 B, the rest 256 B) and reads ~1.1 KB
// (its root row, K1's accumulator row, six scalars, the history seeds);
// at 3.35 TB/s that is ~25 us for 1024 lanes, ~1.6 us for 64.
//
// Design: one block per listed lane; its threads stride over each of the
// lane's tables with coalesced 4-byte stores. The accumulators are f32
// or int32 (int8 net); both are copied as 32-bit words, and a zero word
// is 0.0f. The jitter mix is the reference's uint32 arithmetic:
// (j * 2654435761 ^ idx * 2246822519), then ^ >> 15, then & 255, and 0
// where j == 0. lane_idx must be distinct (the caller checks); an index
// outside [0, batch) is skipped.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int INF = 32500;
constexpr int MAX_HIST = 16;
constexpr int HIST_SIZE = 4096;
// nt fields (ops/search.py)
constexpr int NT_W = 16;
constexpr int NT_ALPHA = 3, NT_ALPHA0 = 4, NT_BETA = 5, NT_BEST = 6, NT_BMOVE = 7;
constexpr int NT_DL = 11, NT_K0 = 13, NT_K1 = 14;
// bt fields
constexpr int BT_W = 96;
constexpr int BT_EP = 65, BT_CAST = 66;
// lane fields
constexpr int LN_W = 16;
constexpr int LN_DLIM = 7, LN_BUDGET = 8, LN_RSCORE = 9, LN_RMOVE = 10;
constexpr int LN_RALPHA = 11, LN_RBETA = 12, LN_JITTER = 14, LN_GROUP = 15;

__device__ __forceinline__ int32_t nt_init(int col) {
    switch (col) {
        case NT_ALPHA: case NT_ALPHA0: case NT_BEST: return -INF;
        case NT_BETA: return INF;
        case NT_BMOVE: case NT_K0: case NT_K1: return -1;
        default: return 0;
    }
}

__global__ void lane_init_kernel(
        int32_t* __restrict__ bt, int32_t* __restrict__ nt, int32_t* __restrict__ lane,
        int32_t* __restrict__ hist_hash, int32_t* __restrict__ hist_halfmove,
        int32_t* __restrict__ moves, int32_t* __restrict__ hist, int32_t* __restrict__ pv,
        int32_t* __restrict__ acc,
        const int64_t* __restrict__ lane_idx, const int32_t* __restrict__ rows,
        const int32_t* __restrict__ root_acc, const int32_t* __restrict__ depth,
        const int32_t* __restrict__ budget, const int32_t* __restrict__ alpha,
        const int32_t* __restrict__ beta, const int32_t* __restrict__ jitter,
        const int32_t* __restrict__ group, const int32_t* __restrict__ hh,
        const int32_t* __restrict__ hm, int batch, int p1, int max_moves, int l1) {
    const int i = blockIdx.x;
    const int64_t b = lane_idx[i];
    if (b < 0 || b >= batch) return;
    const int t = threadIdx.x;
    const int p = p1 - 1;

    // board rows: row 0 the root, the rest empty
    int32_t* btl = bt + b * p1 * BT_W;
    const int32_t* root = rows + (int64_t)i * BT_W;
    for (int k = t; k < p1 * BT_W; k += THREADS) {
        int c = k % BT_W;
        btl[k] = k < BT_W ? root[c] : (c == BT_EP || (c >= BT_CAST && c < BT_CAST + 4)) ? -1 : 0;
    }
    // node scalars: the constants, the depth in row 0
    const int32_t d = depth[i];
    int32_t* ntl = nt + b * p1 * NT_W;
    for (int k = t; k < p1 * NT_W; k += THREADS) {
        ntl[k] = k == NT_DL ? d : nt_init(k % NT_W);
    }
    // lane scalars and the game-history seeds
    if (t < LN_W) {
        int32_t v = 0;
        switch (t) {
            case LN_DLIM: v = d; break;
            case LN_BUDGET: v = budget[i]; break;
            case LN_RSCORE: v = -INF; break;
            case LN_RMOVE: v = -1; break;
            case LN_RALPHA: v = alpha[i]; break;
            case LN_RBETA: v = beta[i]; break;
            case LN_JITTER: v = jitter[i]; break;
            case LN_GROUP: v = group[i]; break;
        }
        lane[b * LN_W + t] = v;
    } else if (t < LN_W + 2 * MAX_HIST) {
        int k = t - LN_W;
        hist_hash[b * 2 * MAX_HIST + k] = hh[(int64_t)i * 2 * MAX_HIST + k];
    } else if (t < LN_W + 3 * MAX_HIST) {
        int k = t - LN_W - 2 * MAX_HIST;
        hist_halfmove[b * MAX_HIST + k] = hm[(int64_t)i * MAX_HIST + k];
    }
    // empty move lists and PV table
    int32_t* ml = moves + b * p * max_moves;
    for (int k = t; k < p * max_moves; k += THREADS) ml[k] = -1;
    int32_t* pvl = pv + b * p * p;
    for (int k = t; k < p * p; k += THREADS) pvl[k] = -1;
    // history counters: zeros, or the jitter mix
    const uint32_t j = (uint32_t)jitter[i];
    int32_t* hl = hist + b * HIST_SIZE;
    for (int k = t; k < HIST_SIZE; k += THREADS) {
        uint32_t mix = (j * 2654435761u) ^ ((uint32_t)k * 2246822519u);
        mix ^= mix >> 15;
        hl[k] = j != 0u ? (int32_t)(mix & 255u) : 0;
    }
    // accumulators: row 0 the root's, the rest zero
    int32_t* al = acc + b * p1 * 2 * l1;
    const int32_t* ra = root_acc + (int64_t)i * 2 * l1;
    for (int k = t; k < p1 * 2 * l1; k += THREADS) al[k] = k < 2 * l1 ? ra[k] : 0;
}

}  // namespace

// state tables (batch, ...) int32 (acc f32 or int32, as 32-bit words),
// contiguous; lane_idx (n,) int64; rows (n, 96); root_acc (n, 2, l1);
// depth, budget, alpha, beta, jitter, group (n,); hh (n, 16, 2) int32
// bit patterns; hm (n, 16)
FISHNET_EXPORT int lane_init(void* bt, void* nt, void* lane, void* hist_hash,
                             void* hist_halfmove, void* moves, void* hist, void* pv, void* acc,
                             const void* lane_idx, const void* rows, const void* root_acc,
                             const void* depth, const void* budget, const void* alpha,
                             const void* beta, const void* jitter, const void* group,
                             const void* hh, const void* hm, int batch, int n, int p1,
                             int max_moves, int l1, void* stream) {
    if (n <= 0) return 0;
    lane_init_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)bt, (int32_t*)nt, (int32_t*)lane, (int32_t*)hist_hash,
        (int32_t*)hist_halfmove, (int32_t*)moves, (int32_t*)hist, (int32_t*)pv,
        (int32_t*)acc, (const int64_t*)lane_idx, (const int32_t*)rows,
        (const int32_t*)root_acc, (const int32_t*)depth, (const int32_t*)budget,
        (const int32_t*)alpha, (const int32_t*)beta, (const int32_t*)jitter,
        (const int32_t*)group, (const int32_t*)hh, (const int32_t*)hm, batch, p1, max_moves,
        l1);
    return (int)cudaGetLastError();
}
