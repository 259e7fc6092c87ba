// K11 search_segment: a whole segment of the lockstep search in one launch
// — up to `steps` state-machine steps of every lane, with the TT runner's
// store, probe and leaf store around each step when a table is given,
// stopping after the first step that leaves every lane DONE (a segment
// that starts with every lane DONE runs none), and the packed (B+1, 4)
// summary (done, nodes, root score, root move; row B the step count).
//
// Replaces: fishnet_tpu/ops/search.py:875 _run_segment (its while loop at
// :982, the TT runner at :903-980, the summary at :990) around :343
// _step_lane, vmapped by :838 make_search_step / :847
// make_search_step_tt; in the port, the batched-PyTorch run_segment_plain
// (ops/search.py _step, _tt_step), which launched ~370-420 kernels a step.
//
// Bound on the H100: a step's bytes — each live lane reads and writes its
// 64-byte lane row; an entering lane reads its board row, node rows and
// accumulator pair (~1 KB) and writes its node row, and a lane that
// advances writes the child's board row and accumulator pair (~0.8 KB);
// with a table a few 16-byte rows. ~0.1 MB a step at 64 lanes, ~0.03 us
// of HBM time. What bounds it in practice is each step's dependent chain
// in one warp (the board rules, the move generator's enumeration and rank
// sort, the eval's 2,592 multiply-adds on one thread) plus one grid
// barrier a step without a table and four with one.
//
// Design: a persistent cooperative grid (cudaLaunchCooperativeKernel,
// cooperative_groups grid sync), sized by the occupancy API to the blocks
// that fit on the card at once; one warp per lane (search.cuh step_lane),
// four warps a block, each warp stepping lanes w, w + W, ... so any batch
// fits. The lane tables and the table stay in device memory and are
// updated in place; a warp stages the rows its lane's step reads in
// shared memory. One step with a table: (1) each lane parked in RETURN
// hashes its row and claims its store's slot (atomicMax of the lane index
// in a claim word per slot, the decision taken against the pre-store row,
// as the reference's prefer_deep store reads it), barrier, (2) each
// slot's highest claiming lane writes its row whole and frees the claim,
// barrier, (3) each lane steps (probing the table with the window ENTER
// gives it) and claims its leaf store, barrier, (4) the leaf stores'
// owners write, barrier. That is the reference's order and its colliding-
// store rule (the highest storable lane of a slot wins) in O(B), across
// blocks. Without a table there is no cross-lane dependency: one barrier
// a step, for the exit test. The exit test is a grid-wide "any lane live"
// flag every block reads after the same barrier (three flags in rotation,
// so one is reset while another is read), so all blocks take the same
// number of steps and barriers.
#include <cooperative_groups.h>

#include "search.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace search;

constexpr int WARPS = 4;  // lanes in flight per block
constexpr int THREADS = WARPS * WARP;

template <class Net>
__global__ void __launch_bounds__(THREADS) segment_kernel(const Segment<Net> a) {
    cg::grid_group grid = cg::this_grid();
    __shared__ WarpRows rows[WARPS];
    const int w = threadIdx.x / WARP, t = threadIdx.x % WARP;
    const int first_warp = blockIdx.x * WARPS + w, n_warps = gridDim.x * WARPS;
    WarpRows& s = rows[w];
    const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
    // "any lane live" before step i: flags[i % 3]
    int* flags = a.scratch + (int64_t)a.B * SEGMENT_SCRATCH;
    unsigned calls[N_BODY];
    for (int i = 0; i < N_BODY; ++i) calls[i] = 0;

    if (leader) {
        for (int i = 0; i < 3; ++i) atomicExch(flags + i, 0);
    }
    grid.sync();
    for (int lane = first_warp; lane < a.B; lane += n_warps) {
        if (t == 0 && a.lane[(int64_t)lane * LN_W + LN_MODE] != MODE_DONE) atomicExch(flags, 1);
    }
    grid.sync();
    int n = 0;
    while (n < a.steps && __ldcg(flags + n % 3) != 0) {
        // flags[(n + 2) % 3] was last read before this step's first barrier
        if (leader) atomicExch(flags + (n + 2) % 3, 0);
        if (a.table) {
            for (int lane = first_warp; lane < a.B; lane += n_warps) {
                interior_store_claim(a, lane, s, t, calls);
            }
            grid.sync();
            for (int lane = first_warp; lane < a.B; lane += n_warps) store_commit(a, lane, t);
            grid.sync();
        }
        bool live = false;
        for (int lane = first_warp; lane < a.B; lane += n_warps) {
            live |= step_lane(a, lane, s, t, calls);
        }
        if (t == 0 && live) atomicExch(flags + (n + 1) % 3, 1);
        grid.sync();
        if (a.table) {
            for (int lane = first_warp; lane < a.B; lane += n_warps) store_commit(a, lane, t);
            grid.sync();
        }
        ++n;
    }

    for (int lane = first_warp; lane < a.B; lane += n_warps) {
        if (t < 4) {
            const int32_t* L = a.lane + (int64_t)lane * LN_W;
            const int v = t == SUM_DONE    ? L[LN_MODE] == MODE_DONE
                          : t == SUM_NODES ? L[LN_NODES]
                          : t == SUM_SCORE ? L[LN_RSCORE]
                                           : L[LN_RMOVE];
            a.summary[(int64_t)lane * SUM_W + t] = v;
        }
    }
    if (leader) {
        for (int i = 0; i < SUM_W; ++i) a.summary[(int64_t)a.B * SUM_W + i] = n;
    }
    if (t == 0) {
        for (int i = 0; i < N_BODY; ++i) {
            if (calls[i]) atomicAdd(a.body_calls + i, (unsigned long long)calls[i]);
        }
    }
}

template <class Net>
int launch(Segment<Net> a, int* grid_out, cudaStream_t stream) {
    static int blocks_per_sm = -1, sms = 0;
    if (blocks_per_sm < 0) {
        int dev;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess) {
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, segment_kernel<Net>,
                                                              THREADS, 0);
        }
        if (e != cudaSuccess) {
            blocks_per_sm = -1;
            return (int)e;
        }
    }
    if (blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int want = (a.B + WARPS - 1) / WARPS, fit = blocks_per_sm * sms;
    const int grid = want < fit ? want : fit;
    *grid_out = grid;
    void* args[] = {&a};
    cudaError_t e = cudaLaunchCooperativeKernel((const void*)segment_kernel<Net>, grid, THREADS,
                                                args, 0, stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <class Net>
int segment(void* bt, void* nt, void* lane, const void* hist_hash, const void* hist_halfmove,
            void* moves, void* hist, void* pv, void* acc, const void* ft_w, const void* l1_w,
            const void* l1_b, const void* l2_w, const void* l2_b, const void* out_w,
            const void* out_b, const void* z1, const void* z2, void* table, int table_rows,
            void* claims, const void* gen_lanes, int gen, void* scratch, void* body_calls,
            void* summary, int batch, int max_ply, int max_hist, int steps, int pruning,
            int deep_tt, int prefer_deep, void* grid_out, void* stream) {
    using W = typename Net::HeadW;
    using B = typename Net::HeadB;
    Segment<Net> a;
    a.bt = (int32_t*)bt;
    a.nt = (int32_t*)nt;
    a.lane = (int32_t*)lane;
    a.hist_hash = (const int32_t*)hist_hash;
    a.hist_halfmove = (const int32_t*)hist_halfmove;
    a.moves = (int32_t*)moves;
    a.hist = (int32_t*)hist;
    a.pv = (int32_t*)pv;
    a.acc = (typename Net::Acc*)acc;
    a.ft_w = (const typename Net::FtW*)ft_w;
    a.head = nnue::Head<W, B>{(const W*)l1_w, (const B*)l1_b, (const W*)l2_w,
                              (const B*)l2_b, (const W*)out_w, (const B*)out_b};
    a.z1 = (const uint32_t*)z1;
    a.z2 = (const uint32_t*)z2;
    a.table = (int4*)table;
    a.nmask = (uint32_t)table_rows - 1u;
    a.claims = (int*)claims;
    a.gen_lanes = (const int32_t*)gen_lanes;
    a.gen = gen;
    a.scratch = (int*)scratch;
    a.body_calls = (unsigned long long*)body_calls;
    a.summary = (int32_t*)summary;
    a.B = batch;
    a.P = max_ply;
    a.H = max_hist;
    a.steps = steps;
    a.pruning = pruning != 0;
    a.deep_tt = deep_tt != 0;
    a.prefer_deep = prefer_deep != 0;
    if (max_ply < 1 || max_ply > SEGMENT_MAX_PLY) return (int)cudaErrorInvalidValue;
    return launch<Net>(a, (int*)grid_out, (cudaStream_t)stream);
}

}  // namespace

// The state's nine tables (contiguous: bt (batch, P+1, 96), nt (batch,
// P+1, 16), lane (batch, 16), hist_hash (batch, H, 2), hist_halfmove
// (batch, H), moves (batch, P, MAX_MOVES), hist (batch, 4096), pv (batch,
// P, P), acc (batch, P+1, 2, 64)), the net (ft_w (768, 64) and the head
// weights of K2's shapes), the key tables, the table (n, 4) int32 with n
// = table_rows a power of two, or null, with its claim words (n,) all -1;
// gen_lanes (batch,) int32 or null; scratch (batch * 8 + 4) int32;
// body_calls (9,) int64, added to (kernels.py K11_COUNTERS); summary (batch + 1, 4) int32 out;
// grid_out: the blocks launched (host int).
#define SEGMENT_ENTRY(NAME, NET)                                                           \
    FISHNET_EXPORT int NAME(                                                              \
            void* bt, void* nt, void* lane, const void* hist_hash,                        \
            const void* hist_halfmove, void* moves, void* hist, void* pv, void* acc,      \
            const void* ft_w, const void* l1_w, const void* l1_b, const void* l2_w,       \
            const void* l2_b, const void* out_w, const void* out_b, const void* z1,       \
            const void* z2, void* table, int table_rows, void* claims,                    \
            const void* gen_lanes, int gen, void* scratch, void* body_calls,              \
            void* summary, int batch, int max_ply, int max_hist, int steps, int pruning,  \
            int deep_tt, int prefer_deep, void* grid_out, void* stream) {                 \
        return segment<NET>(bt, nt, lane, hist_hash, hist_halfmove, moves, hist, pv, acc, \
                            ft_w, l1_w, l1_b, l2_w, l2_b, out_w, out_b, z1, z2, table,    \
                            table_rows, claims, gen_lanes, gen, scratch, body_calls,      \
                            summary, batch, max_ply, max_hist, steps, pruning, deep_tt,   \
                            prefer_deep, grid_out, stream);                               \
    }

SEGMENT_ENTRY(search_segment_f32, search::NetF32)
SEGMENT_ENTRY(search_segment_i8, search::NetI8)
