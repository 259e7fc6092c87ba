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
// in one warp (the board rules, the move generator's enumeration and sort,
// the eval's layer stack, one hidden unit's chain a thread) plus one grid
// barrier a step without a table and two with one.
//
// On a king-bucketed or an imported Stockfish net (entry points
// search_segment_kb_* and _sf) every entering lane pays a full eval
// instead (K12's warp body, or K13's units), with the reference's
// full-eval branch (:440-445, :801-812): no accumulator is read or
// written. At L1 3072 that eval reads up to 0.79 MB of feature rows from
// HBM, which then dominates a step's bytes; one warp alone took ~370 us
// for it while the others waited at the barrier. So on a Stockfish net an
// entering lane posts its eval as a job in the launch's scratch (its
// feature lists, stm, bucket: search.cuh sf_post), and every warp that has
// stepped its lanes runs the job's units (sf_help: the feature transform
// in 128-column slices, then fc0 a row a unit) until no warp is still
// stepping; the owner runs its own job's units too and waits for the rest
// (sf_own). A unit never waits and every block of the launch is resident
// (one cluster, or the cooperative grid), so no wait can deadlock; each
// unit keeps its sums' order, so the eval's bits are the one-warp body's.
//
// Variants: the step takes the variant as a template parameter (the
// reference compiles one program per static variant flag), so each
// variant's instantiation carries only its own rules; crazyhouse's also
// its 544-move lists (2,176 B a warp for the staged list, and K9's wider
// scratch: ~9.9 KB of shared memory a warp against ~7.4 KB); atomic's on
// a board768 net a full eval a leaf (the reference's :440-445 and :801):
// K1's refresh of the lane's pair from its board row into the warp's
// shared memory (where every board768 leaf stages its pair for K2's body;
// the 192 KiB of ft_w stay in L2), then K2's body, and no accumulator read
// or written past the root. Each variant is a library of its own, built from this
// source with the generated `segment_entries.cuh` of its build directory,
// which instantiates the five net kinds for it (kernels.py
// segment_entries); kernels.build() runs the eight nvcc processes in
// parallel.
//
// Design: a persistent cooperative grid (cudaLaunchCooperativeKernel,
// cooperative_groups grid sync), sized by the occupancy API to the blocks
// that fit on the card at once; one warp per lane (search.cuh step_lane),
// four warps a block, each warp stepping lanes w, w + W, ... so any batch
// fits. A grid that fits in one thread-block cluster (the main path's 16
// and 64 lanes: 4 and 16 blocks) is launched as that cluster, and its
// barrier is the cluster's hardware barrier instead of the grid sync. The
// lane tables and the table stay in device memory and are updated in
// place; a warp stages the rows its lane's step reads in shared memory.
//
// The table's two stores a step run as K6's body (tt.cuh): a claim half
// (the lane decides against the slot's row, stages its row and takes the
// slot's claim word with atomicMax of its index, so the highest storable
// lane wins) and a commit half (the winner writes its row whole and frees
// the word). Each store kind has its own claim words and staged rows, and
// a read of a slot between a store's halves goes through that store's
// claim words (a claimed slot reads as its winner's staged row), so a
// step with a table takes two barriers: (1) this step's interior stores
// claim, their keep-old decisions reading through the last step's leaf
// claims, and then those leaf stores commit; barrier; (2) each lane steps,
// probing the table and deciding its leaf store's keep-old through the
// interior claims, and claims its leaf store, and then the interior
// stores commit; barrier. A warp commits after its own reads, so the
// reads of a phase find most of its claims still pending. Every read sees
// what the reference's order (interior store | probe, step | leaf store,
// each store reading the table before its own writes) gives it. After
// the last step the leaf stores commit, so every claim word is free again
// when the launch ends. Without a table there is no cross-lane
// dependency: one barrier a step, for the exit test. The exit test is a
// grid-wide "any lane live" flag every block reads after the same barrier
// (three flags in rotation, so one is reset while another is read), so
// all blocks take the same number of steps and barriers.
#include <cooperative_groups.h>

#include "search.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace search;

constexpr int WARPS = 4;  // lanes in flight per block
constexpr int THREADS = WARPS * WARP;

// The barrier every block of the launch passes: the cluster's when the
// grid is one cluster, else the cooperative grid's.
__device__ __forceinline__ void barrier(cg::grid_group& grid, bool one_cluster) {
    if (one_cluster) {
        cg::this_cluster().sync();
    } else {
        grid.sync();
    }
}

template <class Net, int V>
__global__ void __launch_bounds__(THREADS) segment_kernel(const Segment<Net> a) {
    cg::grid_group grid = cg::this_grid();
    const bool one_cluster = a.one_cluster;
    __shared__ WarpRows<V> rows[WARPS];
    const int w = threadIdx.x / WARP, t = threadIdx.x % WARP;
    const int first_warp = blockIdx.x * WARPS + w, n_warps = gridDim.x * WARPS;
    WarpRows<V>& s = rows[w];
    const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
    // "any lane live" before step i: flags[i % 3]
    int* flags = a.scratch + (int64_t)a.B * SEGMENT_SCRATCH;
    unsigned calls[N_BODY];
    for (int i = 0; i < N_BODY; ++i) calls[i] = 0;

    if (leader) {
        for (int i = 0; i < 3; ++i) atomicExch(flags + i, 0);
    }
    if constexpr (Net::KIND == STOCKFISH) {  // step 0's counts; no job record holds a job
        if (leader) {
            atomicExch(a.sf_ctl, 0);
            atomicExch(a.sf_ctl + 3, n_warps);
        }
        for (int k = first_warp * WARP + t; k < a.B; k += n_warps * WARP) {
            __stcg(sf_job(a, k) + SF_JOB_READY, 0);
        }
    }
    barrier(grid, one_cluster);
    for (int lane = first_warp; lane < a.B; lane += n_warps) {
        if (t == 0 && a.lane[(int64_t)lane * LN_W + LN_MODE] != MODE_DONE) atomicExch(flags, 1);
    }
    barrier(grid, one_cluster);
    int n = 0;
    while (n < a.steps && __ldcg(flags + n % 3) != 0) {
        // flags[(n + 2) % 3] was last read before this step's first barrier
        if (leader) atomicExch(flags + (n + 2) % 3, 0);
        if (Net::KIND == STOCKFISH && leader) {  // step n + 1's counts (last read in step n - 2)
            atomicExch(a.sf_ctl + (n + 1) % 3, 0);
            atomicExch(a.sf_ctl + 3 + (n + 1) % 3, n_warps);
        }
        if (a.table) {
            // (1) this step's interior claims, then the last step's leaf commits
            for (int lane = first_warp; lane < a.B; lane += n_warps) {
                interior_store_claim<Net, V>(a, lane, s, t, calls);
            }
            for (int lane = first_warp; lane < a.B && n > 0; lane += n_warps) {
                if (t == 0) tt::store_commit(a.table, a.leaf, lane);
            }
            barrier(grid, one_cluster);
        }
        // (2) the step with its leaf claims, then the interior commits
        bool live = false;
        for (int lane = first_warp; lane < a.B; lane += n_warps) {
            live |= step_lane<Net, V>(a, lane, s, t, calls, n);
        }
        if (t == 0 && live) atomicExch(flags + (n + 1) % 3, 1);
        for (int lane = first_warp; lane < a.B && a.table; lane += n_warps) {
            if (t == 0) tt::store_commit(a.table, a.interior, lane);
        }
        // a Stockfish net's eval units, until no warp is still stepping
        if constexpr (Net::KIND == STOCKFISH) sf_help(a, n, s, t);
        barrier(grid, one_cluster);
        ++n;
    }
    if (a.table && n > 0) {  // the last step's leaf commits
        for (int lane = first_warp; lane < a.B; lane += n_warps) {
            if (t == 0) tt::store_commit(a.table, a.leaf, lane);
        }
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

constexpr int MAX_DEVICES = 64;  // the occupancy cache's devices
constexpr int MAX_CLUSTER = 16;  // the H100's largest (non-portable) cluster

// A launch of `blocks` blocks as one cluster (attr: its attribute's room).
cudaLaunchConfig_t one_cluster_config(int blocks, cudaStream_t stream,
                                      cudaLaunchAttribute& attr) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = blocks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Whether a grid of `blocks` blocks fits in one cluster on the current
// device (the occupancy API, asked once a device and size).
template <class Net, int V>
bool fits_one_cluster(int dev, int blocks) {
    static signed char fits[MAX_DEVICES][MAX_CLUSTER + 1];  // 0 unknown, 1 yes, -1 no
    if (blocks > MAX_CLUSTER) return false;
    if (!fits[dev][blocks]) {
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = one_cluster_config(blocks, 0, attr);
        int clusters = 0;
        cudaError_t e = cudaFuncSetAttribute(segment_kernel<Net, V>,
                                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e == cudaSuccess) {
            e = cudaOccupancyMaxActiveClusters(&clusters, segment_kernel<Net, V>, &cfg);
        }
        if (e != cudaSuccess) cudaGetLastError();  // a refusal means no: clear it
        fits[dev][blocks] = e == cudaSuccess && clusters >= 1 ? 1 : -1;
    }
    return fits[dev][blocks] > 0;
}

template <class Net, int V>
int launch(Segment<Net> a, int* grid_out, cudaStream_t stream) {
    // the grid that fits, read once a device (the current one: each shard
    // of a mesh launches under its own device)
    static int blocks_per_sm[MAX_DEVICES], sms[MAX_DEVICES];
    static bool known[MAX_DEVICES];
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!known[dev]) {
        e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess) {
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm[dev],
                                                              segment_kernel<Net, V>, THREADS, 0);
        }
        if (e != cudaSuccess) return (int)e;
        known[dev] = true;
    }
    if (blocks_per_sm[dev] < 1) return (int)cudaErrorInvalidConfiguration;
    const int want = (a.B + WARPS - 1) / WARPS, fit = blocks_per_sm[dev] * sms[dev];
    const int grid = want < fit ? want : fit;
    *grid_out = grid;
    a.one_cluster = fits_one_cluster<Net, V>(dev, grid);
    if (a.one_cluster) {
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = one_cluster_config(grid, stream, attr);
        e = cudaLaunchKernelEx(&cfg, segment_kernel<Net, V>, a);
    } else {
        void* args[] = {&a};
        e = cudaLaunchCooperativeKernel((const void*)segment_kernel<Net, V>, grid, THREADS, args,
                                        0, stream);
    }
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The net's weights from kernels.py's nine pointers: a board768 or
// king-bucketed net's ft_w, ft_b and six head arrays (the ninth null),
// or an imported Stockfish net's nine arrays (nnue::SfNet's order).
template <typename F, typename W, typename B>
void set_weights(nnue::Net<F, W, B>& n, const void* const* w, int l1, int h1, int h2) {
    n.ft_w = (const F*)w[0];
    n.ft_b = (const B*)w[1];
    n.head = nnue::Head<W, B>{(const W*)w[2], (const B*)w[3], (const W*)w[4], (const B*)w[5],
                              (const W*)w[6], (const B*)w[7], l1, h1, h2};
}
void set_weights(nnue::SfNet& n, const void* const* w, int l1, int, int) {
    n = nnue::SfNet{(const float*)w[0], (const float*)w[1], (const float*)w[2],
                    (const float*)w[3], (const float*)w[4], (const float*)w[5],
                    (const float*)w[6], (const float*)w[7], (const float*)w[8], l1,
                    nnue::sf_vec_ok((const float*)w[0], (const float*)w[1], l1)};
}

// The widths each net kind takes (kernels.py checks them first).
template <class Net>
bool widths_ok(int l1, int h1, int h2) {
    const bool head = h1 > 0 && h1 <= nnue::MAX_H && h2 > 0 && h2 <= nnue::MAX_H;
    if (Net::KIND == BOARD768) return l1 == nnue::L1 && h1 == nnue::H1 && h2 == nnue::H2;
    const bool full = l1 > 0 && l1 <= MAX_L1 && l1 % 2 == 0;
    return Net::KIND == KING ? full && head : full;
}

template <class Net, int V>
int segment(void* bt, void* nt, void* lane, const void* hist_hash, const void* hist_halfmove,
            void* moves, void* hist, void* pv, void* acc, const void* w0, const void* w1,
            const void* w2, const void* w3, const void* w4, const void* w5, const void* w6,
            const void* w7, const void* w8, const void* z1, const void* z2, void* table,
            int table_rows, void* claims, const void* gen_lanes, int gen, void* scratch,
            void* body_calls, void* summary, int batch, int max_ply, int max_hist, int steps,
            int pruning, int deep_tt, int prefer_deep, int l1, int h1, int h2, void* grid_out,
            void* stream) {
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
    const void* weights[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
    set_weights(a.net, weights, l1, h1, h2);
    a.z1 = (const uint32_t*)z1;
    a.z2 = (const uint32_t*)z2;
    a.table = (int4*)table;
    a.nmask = (uint32_t)table_rows - 1u;
    // claims (2, table_rows): the interior store's words, then the leaf
    // store's; each lane's staged rows in its SEGMENT_SCRATCH words
    constexpr int stride = SEGMENT_SCRATCH / 4;
    a.interior = tt::Pending{(int*)claims, (int4*)scratch, stride};
    a.leaf = tt::Pending{(int*)claims + table_rows, (int4*)scratch + 2, stride};
    a.gen_lanes = (const int32_t*)gen_lanes;
    a.gen = gen;
    a.scratch = (int*)scratch;
    a.sf_ctl = a.sf_jobs = nullptr;
    a.sf_buf = nullptr;
    if (Net::KIND == STOCKFISH) {  // after the stores' rows and the live flags
        a.sf_ctl = a.scratch + (int64_t)batch * SEGMENT_SCRATCH + 4;
        a.sf_jobs = a.sf_ctl + SF_CTL_W;
        a.sf_buf = (float*)(a.sf_jobs + (int64_t)batch * SF_JOB_W);
    }
    a.body_calls = (unsigned long long*)body_calls;
    a.summary = (int32_t*)summary;
    a.B = batch;
    a.P = max_ply;
    a.H = max_hist;
    a.steps = steps;
    a.pruning = pruning != 0;
    a.deep_tt = deep_tt != 0;
    a.prefer_deep = prefer_deep != 0;
    if (max_ply < 1 || max_ply > SEGMENT_MAX_PLY || !widths_ok<Net>(l1, h1, h2)) {
        return (int)cudaErrorInvalidValue;
    }
    return launch<Net, V>(a, (int*)grid_out, (cudaStream_t)stream);
}

}  // namespace

// The state's nine tables (contiguous: bt (batch, P+1, 96), nt (batch,
// P+1, 16), lane (batch, 16), hist_hash (batch, H, 2), hist_halfmove
// (batch, H), moves (batch, P, the variant's MAX_MOVES or MAX_MOVES_ZH),
// hist (batch, 4096), pv (batch,
// P, P), acc (batch, P+1, 2, l1)), the net's nine weight pointers
// (set_weights: a board768 net of l1 64, a king-bucketed net, or an
// imported Stockfish net, with l1, h1, h2), the key tables, the table (n,
// 4) int32 with n = table_rows a power of two, or null, with its claim
// words (2, n) all -1 (left so); gen_lanes (batch,) int32 or null;
// scratch (batch * SEGMENT_SCRATCH + 4) int32, on a Stockfish net
// followed by SF_CTL_W + batch * (SF_JOB_W + nnue::sf_buffer_floats(l1))
// words (the spread evals' counters, jobs and buffers; kernels.py
// segment_scratch_words); body_calls (13,) int64,
// added to (kernels.py K11_COUNTERS); summary (batch + 1, 4) int32 out;
// grid_out: the blocks launched (host int). The entry points of one
// variant's library, one per net kind, are the generated
// segment_entries.cuh's SEGMENT_ENTRY(name, net, variant) lines.
#define SEGMENT_ENTRY(NAME, NET, V)                                                        \
    FISHNET_EXPORT int NAME(                                                              \
            void* bt, void* nt, void* lane, const void* hist_hash,                        \
            const void* hist_halfmove, void* moves, void* hist, void* pv, void* acc,      \
            const void* w0, const void* w1, const void* w2, const void* w3,               \
            const void* w4, const void* w5, const void* w6, const void* w7,               \
            const void* w8, const void* z1, const void* z2, void* table, int table_rows,  \
            void* claims, const void* gen_lanes, int gen, void* scratch,                  \
            void* body_calls, void* summary, int batch, int max_ply, int max_hist,        \
            int steps, int pruning, int deep_tt, int prefer_deep, int l1, int h1, int h2, \
            void* grid_out, void* stream) {                                               \
        return segment<NET, V>(bt, nt, lane, hist_hash, hist_halfmove, moves, hist, pv,  \
                               acc, w0, w1, w2, w3, w4, w5, w6, w7, w8, z1, z2, table,    \
                               table_rows, claims, gen_lanes, gen, scratch, body_calls,   \
                               summary, batch, max_ply, max_hist, steps, pruning,         \
                               deep_tt, prefer_deep, l1, h1, h2, grid_out, stream);       \
    }

#include "segment_entries.cuh"
